"""Share of the card's bf16 peak that the serve-decode window's decode steps
take: each token after a request's first (which its prefill gives) at 2 x
parameters plus attention over its live context
(``_work.decoded_flops``), over the window. The prefills are not counted,
so this moves with the decode step alone."""

import _work


def read(rec):
    reqs = rec.info.get("requests")
    if not reqs or rec.window_s <= 0:
        return None
    flops = _work.decoded_flops(rec.info["cfg"], reqs)
    return 100.0 * flops / (rec.window_s * _work.BF16_FLOPS)
