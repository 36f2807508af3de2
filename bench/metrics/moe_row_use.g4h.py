"""Share of the rows the decode step's routed experts compute that the
routing needs, in g4h-decode: the program's counters
``moe.decode.rows_needed`` (tokens x top-k) over
``moe.decode.rows_computed`` (``models/moe.py::dropless_moe_apply``, from
shapes, once a pass; a captured step counts once, at its capture): 16 x
10 / (72 x 16) = 13.89% while every expert computes every slot. A
program without them gives None."""

import _spans


def read(rec):
    c = _spans.program_counters()
    if not c or not c.get("moe.decode.rows_computed"):
        return None
    return 100.0 * c["moe.decode.rows_needed"] / c["moe.decode.rows_computed"]
