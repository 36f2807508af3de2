"""Share of the query-key pairs the prefill's blockwise attention computes
that causal attention needs: the program's counters
``attn.pairs_needed`` over ``attn.pairs_computed``
(``models/common.py::blockwise_attention``; every tile pair is
computed, masked or not, and the last tile is padded). Counted only
while the traced window records."""

import _spans


def read(rec):
    c = _spans.program_counters()
    if not c or not c.get("attn.pairs_computed"):
        return None
    return 100.0 * c["attn.pairs_needed"] / c["attn.pairs_computed"]
