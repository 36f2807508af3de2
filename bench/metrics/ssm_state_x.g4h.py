"""Bytes of state-shaped intermediates the Mamba-2 decode update
materialises for each byte of resident recurrent state it reads: the
program's counters ``ssm.decode.work_bytes`` over
``ssm.decode.state_bytes`` (``models/ssm.py::mamba2_apply``, from shapes,
once a pass; a captured step counts once, at its capture). An update
fused in place would read 0. A program without them gives None."""

import _spans


def read(rec):
    c = _spans.program_counters()
    if not c or not c.get("ssm.decode.state_bytes"):
        return None
    return c.get("ssm.decode.work_bytes", 0) / c["ssm.decode.state_bytes"]
