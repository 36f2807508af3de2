"""Block/grid sweep harness: ``core.autotune.tune_design`` over the
kernel registry.

``tune_op`` tunes one registered op on representative operands: the
candidate axes are clamped to the operand extents (``api.clamped_axes``),
each point is timed (the first call, which builds and loads the kernel, is
excluded; median of ``iters`` reps), and the winner is persisted to the
tuned-point cache (``repro_torch.kernels.tuned``) keyed by (op, shape_key,
device_kind). A second run for the same cell is served from the cache with
ZERO re-evaluations -- every ``api.call`` picks up tuned blocks at op-call
time without re-running a sweep.

The example operands live on the card (an op's ``example`` raises
without one, so the plain versions are never timed and cached as the
card's); operands passed as ``args`` are timed where they lie. Each timed
call ends in ``torch.cuda.synchronize()``, so the wall time covers the
kernels' work and not only their launch.

Kernel spaces are small (a few block-size candidates per axis), so the
sweep runs ``tune_design`` exhaustively when the clamped grid is tiny and
falls back to the coordinate-descent hillclimb above ``EXHAUSTIVE_MAX``
points -- the same memoized, deterministic walk.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.autotune import tune_design
from repro_torch.kernels import api, tuned

EXHAUSTIVE_MAX = 64                     # full grid at or below this size


@dataclasses.dataclass
class TuneOutcome:
    op: str
    shape_key: str
    point: Dict[str, Any]               # winning (clamped) point
    default: Dict[str, Any]             # clamped default for this cell
    objective_us: float
    evaluations: int                    # 0 on a cache hit
    cache_hit: bool
    history: Tuple = ()


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_point(op: api.TunableOp, point: Dict[str, Any], args, kwargs,
               iters: int = 3) -> float:
    """Median wall microseconds of the op at one point (the first call
    builds and loads the kernel and is excluded)."""
    op.run(dict(point), *args, **kwargs)
    _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        op.run(dict(point), *args, **kwargs)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e6


def tune_op(name: str, args: Optional[tuple] = None,
            kwargs: Optional[dict] = None, *, quick: bool = True,
            iters: int = 3, force: bool = False) -> TuneOutcome:
    """Tune one op for one operand cell; cache-first.

    ``args``/``kwargs`` default to the op's registered example operands,
    built on the card (``quick`` picks the CI-smoke cell). ``force=True``
    re-sweeps even on a cache hit (the refresh path).
    """
    op = api.get_op(name)
    if args is None:
        args, kwargs = op.example(quick)
    kwargs = dict(kwargs or {})
    skey = op.shape_key(*args, **kwargs)
    base = op.clamp(api.default_point(op), *args, **kwargs)

    if not force:
        cached = tuned.lookup(name, skey)
        if cached is not None:
            rec = tuned.entry(name, skey) or {}
            point = op.clamp({**api.default_point(op), **cached},
                             *args, **kwargs)
            return TuneOutcome(op=name, shape_key=skey, point=point,
                               default=base,
                               objective_us=float(rec.get("objective_us", 0.0)),
                               evaluations=0, cache_hit=True)

    axes = api.clamped_axes(op, *args, **kwargs)
    grid_size = 1
    for vals in axes.values():
        grid_size *= len(vals)

    def evaluate(point: Dict[str, Any]) -> float:
        return time_point(op, op.clamp(dict(point), *args, **kwargs),
                          args, kwargs, iters=iters)

    res = tune_design(evaluate, axes, start=base,
                      exhaustive=grid_size <= EXHAUSTIVE_MAX)
    tuned.store(name, skey, res.best_point, objective_us=res.best_objective,
                evaluations=res.evaluations)
    return TuneOutcome(op=name, shape_key=skey, point=dict(res.best_point),
                       default=base, objective_us=res.best_objective,
                       evaluations=res.evaluations, cache_hit=False,
                       history=tuple(res.history))


def tune_registry(quick: bool = True, iters: int = 3,
                  force: bool = False) -> Dict[str, TuneOutcome]:
    """Sweep every registered op on its example cell (registration order
    is deterministic: the builtin import order in ``api``)."""
    return {name: tune_op(name, quick=quick, iters=iters, force=force)
            for name in api.ops()}
