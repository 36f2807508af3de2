"""Share of the card's bf16 peak that the g4h-decode window's decode
steps take: each token after a request's first (which its prefill gives)
at the work ``_work_hybrid.decoded_flops`` counts (the Mamba-2 layers'
projections, conv and recurrence, the attention layers' projections and
attention over the live context, the router, the top-k and shared
experts, the head), over the window, as ``mfu.decode`` counts a dense
model's. The prefills are not counted."""

import _work
import _work_hybrid


def read(rec):
    reqs = rec.info.get("requests")
    if not reqs or rec.window_s <= 0:
        return None
    flops = _work_hybrid.decoded_flops(rec.info["cfg"], reqs)
    return 100.0 * flops / (rec.window_s * _work.BF16_FLOPS)
