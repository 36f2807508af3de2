"""Faults planted in the program underneath a run, for the tests that show
the check catches them and for ``calibrate.py``'s readings: each is a
context manager that patches one function of the port and restores it.

- ``alter_token``: the slot engine's greedy pick changes every seventh
  token it produces (serving);
- ``alter_logits``: the prefill step's logits move one entry (serving);
- ``swap_chunks``: the merge's chunk gather swaps its first two chunks, so
  an output's tokens leave their inputs' order (the table's guarantee);
- ``flip_token``: the merge's gather changes one token of each output.
"""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patch(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def alter_token():
    from repro_torch.launch import serve
    count = [0]

    def new(old):
        def greedy(logits):
            out = old(logits).copy()
            for i in range(out.size):
                count[0] += 1
                if count[0] % 7 == 0:
                    out.flat[i] = (out.flat[i] + 1) % logits.shape[-1]
            return out
        return greedy
    return _patch(serve, "_greedy", new)


def alter_logits():
    from repro_torch.train import step

    def new(old):
        def make(*a, **kw):
            inner = old(*a, **kw)

            def prefill(params, batch):
                logits, cache = inner(params, batch)
                logits = logits.clone()
                logits[..., 0] += 4 * logits.float().std()
                return logits, cache
            return prefill
        return make
    return _patch(step, "make_prefill_step", new)


def swap_chunks():
    from repro_torch.data import packing

    def new(old):
        def compact(src, chunk_map, **kw):
            cm = np.array(chunk_map)
            if cm.size >= 2:
                cm[[0, 1]] = cm[[1, 0]]
            return old(src, cm, **kw)
        return compact
    return _patch(packing, "compact_chunks", new)


def flip_token():
    from repro_torch.data import packing

    def new(old):
        def compact(src, chunk_map, **kw):
            out = old(src, chunk_map, **kw)
            if out.numel():
                out = out.clone()
                out[0] += 1
            return out
        return compact
    return _patch(packing, "compact_chunks", new)


PLANTS = {f.__name__: f for f in (alter_token, alter_logits, swap_chunks,
                                   flip_token)}


def plant(name: str):
    """The named fault as a context manager (``"none"``: no fault)."""
    if name == "none":
        return contextlib.nullcontext()
    return PLANTS[name]()

