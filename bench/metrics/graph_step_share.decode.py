"""Share of the slot engine's decode steps that replayed its CUDA graph:
the program's counter ``serve.graph.replays``
(``launch/serve.py::_SlotStep``) over the decode steps of the traced
window (``_generate_slots.last_stats["decode_steps"]``, summed over the
window's calls). A program that records no ``serve.graph.*`` counter
gives None."""

import _spans


def read(rec):
    c = _spans.program_counters()
    steps = rec.counters.get("decode_steps", 0)
    if not c or not steps or not any(k.startswith("serve.graph.")
                                     for k in c):
        return None
    return 100.0 * c.get("serve.graph.replays", 0) / steps
