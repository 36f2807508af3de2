"""Auto-tuning of compaction triggers (§6.3): iteratively refine trigger
thresholds against an end-to-end workload objective.

The paper uses MLOS+FLAML; this is a dependency-free deterministic stand-in
with the same interface: propose -> evaluate(threshold) -> observe duration.
Strategy: coarse grid sweep, then successive halving around the incumbent
(golden-section-flavored local refinement). :func:`tune_design` extends the
same propose/evaluate/observe loop to *discrete* design spaces (the serve
path's cache-transfer x kv-storage x stream-block sweep) via memoized
coordinate-descent hillclimbing.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class TuneResult:
    history: List[Tuple[float, float]]      # (threshold, objective)
    best_threshold: float
    best_objective: float
    iterations: int


def tune_threshold(evaluate: Callable[[float], float],
                   lo: float, hi: float,
                   coarse: int = 5, refine_rounds: int = 3,
                   minimize: bool = True) -> TuneResult:
    """Tune a single trigger threshold in [lo, hi].

    ``evaluate`` runs the workload under the threshold and returns the
    end-to-end duration (the y-axis of Fig. 9). Deterministic: same
    evaluate -> same result.
    """
    sign = 1.0 if minimize else -1.0
    history: List[Tuple[float, float]] = []

    def ev(x: float) -> float:
        y = evaluate(x)
        history.append((x, y))
        return sign * y

    # coarse grid
    grid = [lo + (hi - lo) * i / (coarse - 1) for i in range(coarse)]
    scores = [(ev(x), x) for x in grid]
    best_s, best_x = min(scores)

    # successive halving around incumbent
    span = (hi - lo) / (coarse - 1)
    for _ in range(refine_rounds):
        span /= 2
        for cand in (best_x - span, best_x + span):
            if lo <= cand <= hi:
                s = ev(cand)
                if s < best_s:
                    best_s, best_x = s, cand
    return TuneResult(history=history, best_threshold=best_x,
                      best_objective=sign * best_s, iterations=len(history))


@dataclasses.dataclass
class DesignResult:
    history: List[Tuple[Dict[str, object], float]]   # (point, objective)
    best_point: Dict[str, object]
    best_objective: float
    evaluations: int
    rounds: int


def tune_design(evaluate: Callable[[Dict[str, object]], float],
                axes: Dict[str, Sequence],
                minimize: bool = True,
                max_rounds: int = 8,
                start: Optional[Dict[str, object]] = None,
                exhaustive: bool = False) -> DesignResult:
    """Coordinate-descent hillclimb over a *discrete* design space.

    ``axes`` maps each knob to its ordered candidate values (e.g.
    ``{"cache_transfer": ("bf16", "int8"), "kv_storage": ("bf16", "int8",
    "f8"), "block": (128, 256, 512)}`` — the serve-path transfer x storage
    x block space the dryrun sweeps). Starting from the first value of
    every axis (or from ``start``, e.g. an incumbent fleet class profile
    being re-tuned warm), each round walks the axes in declaration order
    and moves one coordinate at a time to its best value with the others
    held fixed; the climb stops at the first round that moves nothing.
    Deterministic (axis and value order fix the walk) and memoized, so a
    point is never evaluated twice — with N axes of k values each, at most
    1 + rounds * N * (k - 1) evaluations instead of k**N.

    ``exhaustive=True`` evaluates the full cartesian product instead (the
    kernel block sweeps use this: their spaces are a handful of block-size
    candidates, small enough that the guaranteed optimum is worth k**N
    evaluations). Same memoization, history, and result shape.
    """
    sign = 1.0 if minimize else -1.0
    history: List[Tuple[Dict[str, object], float]] = []
    memo: Dict[Tuple, float] = {}

    def ev(point: Dict[str, object]) -> float:
        key = tuple(point[a] for a in axes)
        if key not in memo:
            y = evaluate(dict(point))
            memo[key] = sign * y
            history.append((dict(point), y))
        return memo[key]

    best = {a: vals[0] for a, vals in axes.items()}
    if start is not None:
        for a, vals in axes.items():
            if a in start and start[a] in vals:
                best[a] = start[a]
    best_s = ev(best)
    if exhaustive:
        names = list(axes)
        for combo in itertools.product(*axes.values()):
            point = dict(zip(names, combo))
            s = ev(point)
            if s < best_s:
                best, best_s = point, s
        return DesignResult(history=history, best_point=best,
                            best_objective=sign * best_s,
                            evaluations=len(history), rounds=1)
    rounds = 0
    for _ in range(max_rounds):
        rounds += 1
        moved = False
        for axis, vals in axes.items():
            for cand in vals:
                if cand == best[axis]:
                    continue
                point = {**best, axis: cand}
                s = ev(point)
                if s < best_s:
                    best, best_s = point, s
                    moved = True
        if not moved:
            break
    return DesignResult(history=history, best_point=best,
                        best_objective=sign * best_s,
                        evaluations=len(history), rounds=rounds)


def tune_weights(evaluate: Callable[[Dict[str, float]], float],
                 benefit_trait: str, cost_trait: str,
                 grid: Sequence[float] = (0.3, 0.5, 0.7, 0.9),
                 minimize: bool = True) -> Tuple[Dict[str, float], float]:
    """Sweep the MOOP benefit weight w1 (w2 = 1 - w1)."""
    sign = 1.0 if minimize else -1.0
    best = None
    for w1 in grid:
        w = {benefit_trait: w1, cost_trait: 1.0 - w1}
        y = sign * evaluate(w)
        if best is None or y < best[1]:
            best = (w, y)
    return best[0], sign * best[1]
