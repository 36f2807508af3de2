"""Decide phase (§4.3): rank candidates and select work.

Two regimes, exactly as the paper:

* Unconstrained: ``ThresholdPolicy`` — act immediately when a trait crosses
  a threshold (e.g. estimated file-count reduction >= 10%).
* Resource-constrained: ``MoopRanker`` — min-max normalize each trait across
  the pool, scalarize with a weighted sum (benefits positive, costs
  negative), rank descending; then ``select_topk`` / ``select_budget``
  (greedy fit into a GBHr budget).

All ranking is deterministic (NFR2): ties break on (-score, table_id,
partition).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.model import Candidate


def minmax_normalize(cands: Sequence[Candidate], trait_names: Sequence[str]
                     ) -> None:
    """T'_{i,c} = (T_{i,c} - min T_i) / (max T_i - min T_i), in [0, 1]."""
    for name in trait_names:
        vals = [c.traits.get(name, 0.0) for c in cands]
        lo, hi = (min(vals), max(vals)) if vals else (0.0, 0.0)
        span = hi - lo
        for c in cands:
            c.normalized[name] = 0.0 if span <= 0 else \
                (c.traits.get(name, 0.0) - lo) / span


FLEET_NORM_TRAITS = ("file_count_reduction", "reclaim_bytes", "compute_cost")


def pooled_benefit(c: Candidate) -> float:
    """Benefit of a pooled (fleet) candidate: normalized file-count
    reduction PLUS normalized reclaimed bytes.

    The reclaim term is the rewrite-delete pricing fix: a delete
    candidate's value is the rows/bytes it removes from the table, and a
    drop-heavy candidate — a GDPR rewrite over two large files, a
    retention drop of one cold partition — may barely reduce the file
    count at all. Scoring benefit on ``file_count_reduction`` alone priced
    such candidates near zero, so they never won the shared budget against
    ordinary compaction no matter how many bytes they reclaimed. Pools
    without any ``reclaim_bytes`` trait are unaffected: min-max
    normalization maps the all-absent trait to 0 for every candidate."""
    return (c.normalized.get("file_count_reduction", 0.0)
            + c.normalized.get("reclaim_bytes", 0.0))


@dataclasses.dataclass
class ThresholdPolicy:
    """Unconstrained regime: fire when ``trait >= threshold`` (absolute) or,
    with ``relative_to``, when trait/denominator >= threshold."""
    trait: str
    threshold: float
    relative_to: Optional[str] = None    # e.g. "file_count"

    def triggered(self, c: Candidate) -> bool:
        val = c.traits.get(self.trait, 0.0)
        if self.relative_to:
            denom = float(getattr(c.stats, self.relative_to, 0) or 0)
            if denom <= 0:
                return False
            val = val / denom
        return val >= self.threshold

    def decide(self, cands: Iterable[Candidate]) -> List[Candidate]:
        out = [c for c in cands if self.triggered(c)]
        out.sort(key=lambda c: (-c.traits.get(self.trait, 0.0),) + c.key)
        return out


class MoopRanker:
    """Weighted-sum scalarization of the multi-objective problem:
        S_c = Σ_benefit w_i T'_i  -  Σ_cost w_j T'_j ,  Σ w = 1.
    """

    def __init__(self, weights: Dict[str, float], costs: Sequence[str] = ("compute_cost",)):
        total = sum(weights.values())
        if not 0.999 <= total <= 1.001:
            raise ValueError(f"MOOP weights must sum to 1 (got {total})")
        self.weights = dict(weights)
        self.costs = set(costs)

    def rank(self, cands: Sequence[Candidate]) -> List[Candidate]:
        minmax_normalize(cands, list(self.weights))
        for c in cands:
            s = 0.0
            for name, w in self.weights.items():
                t = c.normalized.get(name, 0.0)
                s += -w * t if name in self.costs else w * t
            c.score = s
        return sorted(cands, key=lambda c: (-c.score,) + c.key)


def quota_adaptive_weights(used_quota: float, total_quota: float,
                           cost_trait: str = "compute_cost",
                           benefit_trait: str = "file_count_reduction"
                           ) -> Dict[str, float]:
    """Production weight adaptation (§7):
        w1 = 0.5 * (1 + UsedQuota/TotalQuota),  w2 = 1 - w1.
    A tenant near its namespace quota gets more aggressive compaction."""
    util = 0.0 if total_quota <= 0 else min(1.0, used_quota / total_quota)
    w1 = 0.5 * (1.0 + util)
    w1 = min(w1, 1.0)
    return {benefit_trait: w1, cost_trait: 1.0 - w1}


def select_topk(ranked: Sequence[Candidate], k: int) -> List[Candidate]:
    return list(ranked[:k])


def select_budget(ranked: Sequence[Candidate], budget_gbhr: float,
                  cost_trait: str = "compute_cost",
                  max_k: Optional[int] = None,
                  unpriced: Optional[List[Candidate]] = None
                  ) -> List[Candidate]:
    """Greedy: fit as many high-priority tasks as possible in the budget
    (§4.3). Deterministic; skips items that don't fit and keeps going.

    A candidate MISSING the cost trait is conservative-skipped (and
    collected into ``unpriced`` when a list is passed): unpriced work must
    never bypass the budget by defaulting to free. An explicit cost of
    0.0 is priced-free and still admissible.
    """
    out: List[Candidate] = []
    spent = 0.0
    for c in ranked:
        cost = c.traits.get(cost_trait)
        if cost is None:
            if unpriced is not None:
                unpriced.append(c)
            continue
        if spent + cost <= budget_gbhr:
            out.append(c)
            spent += cost
        if max_k is not None and len(out) >= max_k:
            break
    return out


# -- injectable selection strategies (the decide tail of the OODA loop) ------
#
# ``AutoCompPipeline`` and ``FleetScheduler`` both end their decide phase in
# one of these objects; the pipeline builds a default from its legacy
# ``top_k``/``budget_gbhr`` knobs, the fleet layer injects a shared-budget
# selection over the pooled candidates of many pipelines.

@dataclasses.dataclass
class TopKSelection:
    """Fixed-k selection (the paper's rollout weeks 3-5)."""
    k: Optional[int] = None

    def select(self, ranked: Sequence[Candidate]) -> List[Candidate]:
        return select_topk(ranked, self.k if self.k is not None
                           else len(ranked))


@dataclasses.dataclass
class BudgetSelection:
    """Dynamic-k under a GBHr budget (§7 week 6+). Records the unpriced
    candidates it conservatively skipped in ``last_unpriced``."""
    budget_gbhr: float
    max_k: Optional[int] = None
    cost_trait: str = "compute_cost"
    last_unpriced: List[Candidate] = dataclasses.field(
        default_factory=list, repr=False)

    def select(self, ranked: Sequence[Candidate]) -> List[Candidate]:
        self.last_unpriced = []
        return select_budget(ranked, self.budget_gbhr,
                             cost_trait=self.cost_trait, max_k=self.max_k,
                             unpriced=self.last_unpriced)
