"""Fleet-scale compaction scheduler: thousands of tables, one budget.

The single-table OODA loop (``AutoCompPipeline``) stays the per-pool policy
object; this layer owns the cross-table decide/act that the paper's future
work calls for (multi-objective, workload-aware compaction across a fleet):

  tables --classify--> workload class --> class pipeline.propose()
                                             |  (observe memoized per
                                             |   snapshot, activity-fed)
         pooled ranked candidates <----------+
                |
         fleet decide: min-max normalize across the WHOLE pool,
           benefit weighted by query frequency (hot tables first),
           aging boost + hard promotion for starved tables,
           greedy fit into the shared GBHr budget
           (unpriced candidates conservatively skipped)
                |
         fleet act: selected candidates dispatched per class through
           that class's scheduler; deferred work reported, not dropped

Workload classes (the trigger/granularity/data-movement policy axes of the
LSM design-space literature, collapsed to profiles):

  append-storm  sustained high-rate small-file ingestion (Arc's ~17k
                files/day/measurement storm) — compact eagerly, partition
                scope, low trigger threshold;
  bursty        interactive bursts — compact on a moderate threshold;
  cold          near-idle long tail — compact only heavy fragmentation
                (budget is better spent on tables queries actually touch);
  steady        everything else — the default profile.

Per-class profiles are plain knob dicts, hillclimbable with
``core.autotune.tune_design`` (see :meth:`FleetScheduler.tune_profile`).

Starvation bound: a fragmented table skipped ``starvation_cycles`` times
gets promoted ahead of the un-starved pool (oldest first) until served, so
no table waits forever behind permanently-hotter neighbors as long as the
budget clears the starved set each cycle.

Determinism (NFR2): the pooled ranking sorts by candidate key before
normalization and breaks every ordering tie on the key, so permuting table
enumeration order never changes the selection.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.act import ActReport, Scheduler
from repro_torch.core.decide import (FLEET_NORM_TRAITS, MoopRanker,
                               minmax_normalize, pooled_benefit,
                               select_budget)
from repro_torch.core.filters import MinSmallFilesFilter
from repro_torch.core.model import Candidate, Scope
from repro_torch.core.observe import StatsCollector
from repro_torch.core.ooda import AutoCompPipeline
from repro_torch.core.orient import (ComputeCostTrait, FileCountReductionTrait,
                               FileEntropyTrait, TraitContext)
from repro_torch.core.retention import RetentionQueue
from repro_torch.lst.catalog import Catalog

MB = 1 << 20

CLASSES = ("append-storm", "bursty", "cold", "steady")


@dataclasses.dataclass(frozen=True)
class ClassProfile:
    """Per-workload-class policy knobs (the axes ``tune_profile``
    hillclimbs). ``scope`` maps to candidate granularity, ``min_small_files``
    is the compaction trigger threshold, ``target_file_mb`` the rewrite
    target size."""
    name: str
    scope: str = "hybrid"               # "table" | "hybrid"
    target_file_mb: int = 512
    min_small_files: int = 4
    top_k: Optional[int] = None         # per-class cap on pooled candidates
    benefit_weight: float = 0.7         # MOOP w1 (w2 = 1 - w1)

    def axes(self) -> Dict[str, Sequence]:
        """Discrete design space for ``tune_design`` (declaration order
        fixes the hillclimb walk)."""
        return {
            "min_small_files": (2, 4, 8, 16, 32),
            "scope": ("hybrid", "table"),
            "target_file_mb": (128, 256, 512),
        }


DEFAULT_PROFILES: Dict[str, ClassProfile] = {
    "append-storm": ClassProfile("append-storm", scope="hybrid",
                                 min_small_files=4),
    "bursty": ClassProfile("bursty", scope="hybrid", min_small_files=8),
    "cold": ClassProfile("cold", scope="table", min_small_files=32),
    "steady": ClassProfile("steady", scope="table", min_small_files=8),
}


def classify_table(read_rate: float, write_file_rate: float,
                   burstiness: float,
                   storm_file_rate: float = 50.0,
                   bursty_ratio: float = 3.0,
                   cold_rate: float = 0.5) -> str:
    """Map an observed write/query pattern to a workload class. Cold is
    checked before bursty: a near-idle table's lone write always looks
    "bursty" by peak-to-mean, but rates that low belong to the cold tail."""
    if write_file_rate >= storm_file_rate:
        return "append-storm"
    if read_rate < cold_rate and write_file_rate < cold_rate:
        return "cold"
    if burstiness >= bursty_ratio and write_file_rate > 0:
        return "bursty"
    return "steady"


def build_class_pipeline(profile: ClassProfile, activity=None,
                         stats: Optional[StatsCollector] = None,
                         scheduler: Optional[Scheduler] = None,
                         executor_memory_gb: float = 8.0,
                         rewrite_bytes_per_hour: float = 256e9
                         ) -> AutoCompPipeline:
    """One per-class policy pipeline: its propose() half feeds the fleet
    pool; its scheduler is the class's act tail. Pass a shared ``stats``
    collector so tables that migrate between classes with the same target
    size keep their memoized observations."""
    target = profile.target_file_mb * MB
    w1 = profile.benefit_weight
    return AutoCompPipeline(
        stats=stats if stats is not None
        else StatsCollector(target, activity=activity),
        traits=(FileCountReductionTrait(partition_aware=True),
                FileEntropyTrait(), ComputeCostTrait()),
        trait_ctx=TraitContext(target_file_bytes=target,
                               executor_memory_gb=executor_memory_gb,
                               rewrite_bytes_per_hour=rewrite_bytes_per_hour),
        ranker=MoopRanker({"file_count_reduction": w1,
                           "compute_cost": 1.0 - w1}),
        scheduler=scheduler if scheduler is not None else Scheduler(target),
        scope=Scope.TABLE,
        hybrid=(profile.scope == "hybrid"),
        pre_filters=(MinSmallFilesFilter(profile.min_small_files),),
        top_k=profile.top_k,
    )


@dataclasses.dataclass
class FleetCycleReport:
    """CycleReport-shaped (duck-typed for AutoCompService) plus the
    fleet-level accounting the bench artifact and the gate read."""
    n_tables: int = 0
    n_candidates: int = 0
    n_delete_candidates: int = 0
    n_selected: int = 0
    n_unpriced: int = 0
    selected_keys: List = dataclasses.field(default_factory=list)
    deferred_keys: List = dataclasses.field(default_factory=list)
    class_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    budget_gbhr: float = 0.0
    spent_gbhr: float = 0.0              # Σ selected compute_cost
    starved_served: int = 0              # promoted tables served this cycle
    max_skip_cycles: int = 0             # worst aging among fragmented tables
    act: Optional[ActReport] = None
    wall_s: float = 0.0
    # retention accounting (delete candidates only; see core.retention)
    rows_dropped: int = 0
    files_dropped: int = 0               # tier-1 metadata drops (0 bytes)
    retention_bytes_rewritten: int = 0   # tier-2 rewrite-delete bytes
    bytes_reclaimed: int = 0

    @property
    def files_removed(self) -> int:
        return self.act.files_removed if self.act else 0

    @property
    def gbhr(self) -> float:
        return self.act.gbhr if self.act else 0.0


class FleetScheduler:
    """Cross-table decide/act over many per-class pipelines under one
    shared GBHr budget."""

    def __init__(self, catalog: Catalog, budget_gbhr: float,
                 activity=None,
                 profiles: Optional[Dict[str, ClassProfile]] = None,
                 starvation_cycles: int = 5,
                 aging_boost: float = 0.5,
                 query_weight: float = 0.5,
                 benefit_weight: float = 0.7,
                 max_k: Optional[int] = None,
                 classify_fn: Optional[Callable[..., str]] = None,
                 pipeline_factory: Callable = build_class_pipeline,
                 retention: Optional[RetentionQueue] = None) -> None:
        self.catalog = catalog
        self.budget_gbhr = budget_gbhr
        self.activity = activity
        self.retention = retention if retention is not None \
            else RetentionQueue()
        self.profiles = dict(profiles if profiles is not None
                             else DEFAULT_PROFILES)
        self.starvation_cycles = starvation_cycles
        self.aging_boost = aging_boost
        self.query_weight = query_weight
        self.benefit_weight = benefit_weight
        self.max_k = max_k
        self.classify_fn = classify_fn or classify_table
        self.pipeline_factory = pipeline_factory
        # one collector per distinct target size, shared across classes, so
        # a table migrating between same-target classes keeps its memoized
        # observation (class churn must not defeat sub-linear re-observe)
        self._collectors: Dict[int, StatsCollector] = {}
        self.pipelines: Dict[str, AutoCompPipeline] = {
            name: pipeline_factory(p, activity,
                                   stats=self._stats_for(p.target_file_mb))
            for name, p in sorted(self.profiles.items())}
        # aging state: table_id -> consecutive cycles it stayed fragmented
        # (had a surviving candidate) without being served
        self.skip_cycles: Dict[str, int] = {}
        self.max_skip_ever = 0
        self.reports: List[FleetCycleReport] = []

    # ------------------------------------------------------------- classify
    def classify(self, table) -> str:
        if self.activity is None:
            return "steady"
        tid = table.table_id
        return self.classify_fn(self.activity.read_rate(tid),
                                self.activity.write_file_rate(tid),
                                self.activity.burstiness(tid))

    def _stats_for(self, target_file_mb: int) -> StatsCollector:
        target = target_file_mb * MB
        if target not in self._collectors:
            self._collectors[target] = StatsCollector(
                target, activity=self.activity)
        return self._collectors[target]

    # ------------------------------------------------------------- retention
    def submit_retention(self, policy) -> None:
        """Queue a standing ``lst.retention.RetentionPolicy``; every cycle
        routes it and pools a candidate when files currently age out."""
        self.retention.submit(policy)

    def submit_delete(self, op) -> None:
        """Queue a one-shot ``lst.retention.PredicateDelete``; it stays
        pending — surviving deferral and conflicts — until its routed work
        commits on every target table."""
        self.retention.submit(op)

    def set_profile(self, profile: ClassProfile) -> None:
        """Swap a class's policy profile (rebuilds its pipeline around the
        shared collector for the profile's target size)."""
        self.profiles[profile.name] = profile
        self.pipelines[profile.name] = self.pipeline_factory(
            profile, self.activity,
            stats=self._stats_for(profile.target_file_mb))

    def tune_profile(self, name: str,
                     evaluate: Callable[[ClassProfile], float],
                     axes: Optional[Dict[str, Sequence]] = None,
                     max_rounds: int = 4):
        """Hillclimb one class's knobs with ``core.autotune.tune_design``,
        warm-started from the incumbent profile; installs and returns the
        winner."""
        from repro_torch.core.autotune import tune_design
        base = self.profiles[name]
        axes = axes if axes is not None else base.axes()
        start = {a: getattr(base, a) for a in axes}

        def ev(point: Dict[str, object]) -> float:
            return evaluate(dataclasses.replace(base, **point))

        res = tune_design(ev, axes, start=start, max_rounds=max_rounds)
        best = dataclasses.replace(base, **res.best_point)
        self.set_profile(best)
        return best, res

    # --------------------------------------------------------------- decide
    def decide(self, pool: Sequence[Candidate]
               ) -> Tuple[List[Candidate], List[Candidate], List[Candidate]]:
        """Fleet-level ranking + budget selection over the pooled
        candidates. Returns (ranked, selected, unpriced). Pure given the
        pool and aging state; input order never matters (NFR2)."""
        pool = sorted(pool, key=lambda c: c.key)
        minmax_normalize(pool, list(FLEET_NORM_TRAITS))
        qf = [c.stats.custom.get("query_freq", 0.0) if c.stats else 0.0
              for c in pool]
        lo, hi = (min(qf), max(qf)) if qf else (0.0, 0.0)
        span = hi - lo
        n_starve = max(1, self.starvation_cycles)
        for c, q in zip(pool, qf):
            qn = 0.0 if span <= 0 else (q - lo) / span
            benefit = pooled_benefit(c) * (1.0 + self.query_weight * qn)
            skip = self.skip_cycles.get(c.table.table_id, 0)
            c.score = (self.benefit_weight * benefit
                       - (1.0 - self.benefit_weight)
                       * c.normalized.get("compute_cost", 0.0)
                       + self.aging_boost * min(skip, n_starve) / n_starve)

        def starved_rank(c: Candidate) -> int:
            skip = self.skip_cycles.get(c.table.table_id, 0)
            return skip if skip >= self.starvation_cycles else 0

        ranked = sorted(pool,
                        key=lambda c: (-starved_rank(c), -c.score) + c.key)
        unpriced: List[Candidate] = []
        selected = select_budget(ranked, self.budget_gbhr,
                                 max_k=self.max_k, unpriced=unpriced)
        return ranked, selected, unpriced

    # ------------------------------------------------------------ run_cycle
    def run_cycle(self, catalog: Optional[Catalog] = None,
                  tables: Optional[Sequence] = None) -> FleetCycleReport:
        t0 = time.perf_counter()
        catalog = catalog if catalog is not None else self.catalog
        explicit = tables is not None
        tables = list(tables if explicit else catalog.tables())
        if explicit and self.retention.has_pending():
            # an after_write cycle only sees dirty tables; retention work on
            # quiet tables must still enter the pool (a compliance delete
            # can't wait for someone to write to the table)
            have = {t.table_id for t in tables}
            tables += [t for t in self.retention.target_tables(catalog)
                       if t.table_id not in have]
        rep = FleetCycleReport(n_tables=len(tables),
                               budget_gbhr=self.budget_gbhr)

        # classify + propose per class
        groups: Dict[str, List] = {}
        for t in sorted(tables, key=lambda t: t.table_id):
            groups.setdefault(self.classify(t), []).append(t)
        pool: List[Candidate] = []
        for cls in sorted(groups):
            pipe = self.pipelines[cls]
            cands = pipe.propose(catalog, tables=groups[cls])
            cap = self.profiles[cls].top_k
            if cap is not None:
                cands = cands[:cap]
            for c in cands:
                c.fleet_class = cls        # type: ignore[attr-defined]
            pool.extend(cands)
            rep.class_counts[cls] = len(groups[cls])
        # pending delete ops enter the same pool (priced, see core.retention)
        cls_of = {t.table_id: cls
                  for cls, ts in groups.items() for t in ts}
        del_cands = self.retention.propose(tables, activity=self.activity)
        for c in del_cands:
            c.fleet_class = cls_of.get(  # type: ignore[attr-defined]
                c.table.table_id, "steady")
        pool.extend(del_cands)
        rep.n_delete_candidates = len(del_cands)
        rep.n_candidates = len(pool)

        # fleet decide
        _, selected, unpriced = self.decide(pool)
        rep.n_selected = len(selected)
        rep.n_unpriced = len(unpriced)
        rep.selected_keys = [c.key for c in selected]
        rep.spent_gbhr = sum(c.traits.get("compute_cost", 0.0)
                             for c in selected)

        # fleet act: dispatch per class through that class's scheduler
        act = ActReport()
        by_class: Dict[str, List[Candidate]] = {}
        for c in selected:
            by_class.setdefault(c.fleet_class, []).append(c)  # type: ignore
        for cls in sorted(by_class):
            sub = self.pipelines[cls].act.execute(by_class[cls])
            act.results.extend(sub.results)
            act.deferred.extend(sub.deferred)
        rep.act = act
        rep.deferred_keys = [c.key for c in act.deferred]

        # retention accounting + one-shot completion (deferred deletes stay
        # pending in the queue and re-enter next cycle's pool)
        deferred_ids = {id(c) for c in act.deferred}
        for c in selected:
            if c.delete_route is None or id(c) in deferred_ids:
                continue
            results = getattr(c, "delete_results", [])
            rep.rows_dropped += sum(r.rows_dropped for r in results)
            rep.files_dropped += sum(
                r.files_removed for r in results
                if r.files_added == 0 and r.bytes_rewritten == 0)
            rep.retention_bytes_rewritten += sum(
                r.bytes_rewritten for r in results)
            rep.bytes_reclaimed += sum(r.bytes_reclaimed for r in results)
            self.retention.note_executed(c)

        # aging: fragmented-but-unserved tables age; served tables reset.
        # Deferred candidates were selected but NOT executed — they still
        # count as unserved so the window closure can't mask starvation.
        deferred_tables = {c.table.table_id for c in act.deferred}
        served = {c.table.table_id for c in selected} - deferred_tables
        fragmented = {c.table.table_id for c in pool}
        rep.starved_served = sum(
            1 for tid in served
            if self.skip_cycles.get(tid, 0) >= self.starvation_cycles)
        for tid in fragmented:
            if tid in served:
                self.skip_cycles.pop(tid, None)
            else:
                self.skip_cycles[tid] = self.skip_cycles.get(tid, 0) + 1
        for tid in list(self.skip_cycles):
            if tid not in fragmented:      # healed without compaction
                del self.skip_cycles[tid]
        rep.max_skip_cycles = max(self.skip_cycles.values(), default=0)
        self.max_skip_ever = max(self.max_skip_ever, rep.max_skip_cycles)

        rep.wall_s = time.perf_counter() - t0
        self.reports.append(rep)
        return rep

    # ------------------------------------------------------------ telemetry
    def totals(self) -> Dict[str, float]:
        return {
            "cycles": len(self.reports),
            "files_removed": sum(r.files_removed for r in self.reports),
            "gbhr": sum(r.gbhr for r in self.reports),
            "spent_gbhr": sum(r.spent_gbhr for r in self.reports),
            "max_skip_cycles": self.max_skip_ever,
            "deferred": sum(len(r.deferred_keys) for r in self.reports),
            "unpriced": sum(r.n_unpriced for r in self.reports),
            "rows_dropped": sum(r.rows_dropped for r in self.reports),
            "files_dropped": sum(r.files_dropped for r in self.reports),
            "retention_bytes_rewritten": sum(
                r.retention_bytes_rewritten for r in self.reports),
            "bytes_reclaimed": sum(r.bytes_reclaimed for r in self.reports),
        }
