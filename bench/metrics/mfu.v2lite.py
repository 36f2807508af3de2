"""Share of the card's bf16 peak that the v2lite-decode window's decode
steps take: each token after a request's first (which its prefill gives)
at 2 x the weights it multiplies plus absorbed latent attention over its
live context (``_work_mla_moe.decoded_flops``), over the window, as
``mfu.decode`` counts a dense model's. The prefills are not counted."""

import _work
import _work_mla_moe


def read(rec):
    reqs = rec.info.get("requests")
    if not reqs or rec.window_s <= 0:
        return None
    flops = _work_mla_moe.decoded_flops(rec.info["cfg"], reqs)
    return 100.0 * flops / (rec.window_s * _work.BF16_FLOPS)
