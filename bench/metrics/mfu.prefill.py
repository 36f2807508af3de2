"""Share of the card's bf16 peak that causal prefill's needed work takes
(``_work.prefill_flops``: the linear layers, half of the S x S attention
and one logits row), over the summed time of the window's requests."""

import _work


def read(rec):
    reqs = rec.info.get("requests")
    if not reqs:
        return None
    cfg = rec.info["cfg"]
    flops = sum(_work.prefill_flops(cfg, n) for n, _ in reqs)
    return 100.0 * flops / (sum(t for _, t in reqs) * _work.BF16_FLOPS)
