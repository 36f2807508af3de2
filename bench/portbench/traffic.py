"""The general generator of traffic: sizes from a mix's parameters, and
orders and tokens from the seed.

Every seed gets the same set of sizes (the distribution's quantiles), in
its own order, so that two seeds do the same work and differ in its order
and its tokens.
"""

from __future__ import annotations

import math
import statistics
from typing import Any, Dict

import numpy as np


def lengths(spec: Dict[str, Any], n: int) -> np.ndarray:
    """``n`` sizes at the quantiles (i + 0.5) / n of ``spec``'s
    distribution: ``lognormal`` (``median``, ``sigma``) or ``loguniform``,
    clipped to [``min``, ``max``]."""
    qs = [(i + 0.5) / n for i in range(n)]
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        z = statistics.NormalDist()
        vals = [math.exp(math.log(spec["median"])
                         + spec["sigma"] * z.inv_cdf(q)) for q in qs]
    elif spec["dist"] == "loguniform":
        vals = [math.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
                for q in qs]
    else:
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The seed's own stream of draws for one purpose (``stream``)."""
    return np.random.default_rng([int(seed) % (1 << 64)]
                                 + [int(s) for s in stream])


def tokens(gen: np.random.Generator, shape, vocab: int) -> np.ndarray:
    return gen.integers(0, vocab, size=shape, dtype=np.int32)
