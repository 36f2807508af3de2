"""Bytes of per-head K and V the latent-attention decode builds for each
byte of latent and rope cache it reads: the program's counters
``mla.decode.kv_bytes`` over ``mla.decode.latent_bytes``
(``models/attention.py::mla_apply``, from shapes, once a pass; a captured
step counts once, at its capture). A weight-absorbed decode would build
none. A program without them gives None."""

import _spans


def read(rec):
    c = _spans.program_counters()
    if not c or not c.get("mla.decode.latent_bytes"):
        return None
    return c.get("mla.decode.kv_bytes", 0) / c["mla.decode.latent_bytes"]
