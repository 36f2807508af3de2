"""The OODA pipeline (Fig. 4): one configurable object wiring candidates ->
observe -> filters -> orient -> filters -> decide -> act -> feedback.

``run_cycle`` is deterministic given the catalog state (NFR2) and returns a
CycleReport with everything the benchmarks plot.

Fleet refactor: the pipeline is now a per-table/per-namespace *policy
object*. Its front half, :meth:`AutoCompPipeline.propose`, produces the
ranked candidate pool (observe -> orient -> filters -> rank); the decide and
act tails are injectable strategies (``decide=`` anything with
``select(ranked)``, ``act=`` anything with ``execute(selected)`` — by
default the legacy top-k/budget selection and the ``Scheduler``).
``run_cycle`` composes the two halves for standalone single-pool use;
``core.fleet.FleetScheduler`` instead pools ``propose`` output from many
pipelines and owns cross-table decide/act under a shared budget.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch import obs
from repro_torch.core import filters as filt
from repro_torch.core.act import ActReport, Scheduler
from repro_torch.core.decide import (BudgetSelection, MoopRanker, TopKSelection,
                               minmax_normalize)
from repro_torch.core.model import Candidate, Scope, generate_candidates
from repro_torch.core.observe import StatsCollector
from repro_torch.core.orient import TraitContext, compute_traits
from repro_torch.lst.catalog import Catalog


@dataclasses.dataclass
class CycleReport:
    n_candidates: int = 0
    n_after_filters: int = 0
    n_selected: int = 0
    n_unpriced: int = 0          # conservative-skipped: no compute_cost trait
    selected_keys: List = dataclasses.field(default_factory=list)
    deferred_keys: List = dataclasses.field(default_factory=list)
    act: Optional[ActReport] = None
    wall_s: float = 0.0

    @property
    def files_removed(self) -> int:
        return self.act.files_removed if self.act else 0

    @property
    def gbhr(self) -> float:
        return self.act.gbhr if self.act else 0.0


class AutoCompPipeline:
    def __init__(self,
                 stats: StatsCollector,
                 traits: Sequence,
                 trait_ctx: TraitContext,
                 ranker: MoopRanker,
                 scheduler: Optional[Scheduler] = None,
                 scope: Scope = Scope.TABLE,
                 hybrid: bool = False,
                 pre_filters: Sequence = (),
                 post_filters: Sequence = (),
                 top_k: Optional[int] = 10,
                 budget_gbhr: Optional[float] = None,
                 weights_fn: Optional[Callable[[Candidate], Dict[str, float]]] = None,
                 feedback_fn: Optional[Callable] = None,
                 decide=None,
                 act=None) -> None:
        self.stats = stats
        self.traits = traits
        self.trait_ctx = trait_ctx
        self.ranker = ranker
        self.scheduler = scheduler
        self.scope = scope
        self.hybrid = hybrid
        self.pre_filters = list(pre_filters)
        self.post_filters = list(post_filters)
        self.top_k = top_k
        self.budget_gbhr = budget_gbhr
        self.weights_fn = weights_fn
        self.feedback_fn = feedback_fn
        # injectable decide/act tails; defaults reproduce the legacy
        # top_k/budget_gbhr behavior on top of the passed scheduler
        if decide is None:
            decide = (BudgetSelection(budget_gbhr, max_k=top_k)
                      if budget_gbhr is not None else TopKSelection(top_k))
        self.decide = decide
        self.act = act if act is not None else scheduler

    # -- observe -> orient -> rank (the per-pool policy half) ----------------
    def propose(self, catalog: Catalog,
                tables: Optional[Sequence] = None,
                report: Optional[CycleReport] = None) -> List[Candidate]:
        """Produce this pool's ranked candidates. This is the surface the
        fleet scheduler consumes: everything up to (but excluding) the
        decide/act tail."""
        with obs.span("autocomp.observe"):
            cands = generate_candidates(tables if tables is not None
                                        else catalog.tables(),
                                        self.scope, hybrid=self.hybrid)
            if report is not None:
                report.n_candidates = len(cands)
            self.stats.observe_all(cands)
            cands = filt.apply_filters(cands, self.pre_filters)

        with obs.span("autocomp.orient"):
            compute_traits(cands, self.traits, self.trait_ctx)
            cands = filt.apply_filters(cands, self.post_filters)
            if report is not None:
                report.n_after_filters = len(cands)

            # rank (per-candidate quota-adaptive weights if configured)
            if self.weights_fn is not None:
                # re-rank with per-candidate weights: score candidates
                # under their own namespace weights, then order globally
                names = list(self.ranker.weights)
                minmax_normalize(cands, names)
                for c in cands:
                    w = self.weights_fn(c)
                    c.score = sum(
                        (-wv if n in self.ranker.costs else wv)
                        * c.normalized.get(n, 0.0) for n, wv in w.items())
                return sorted(cands, key=lambda c: (-c.score,) + c.key)
            return self.ranker.rank(cands)

    # -- the four phases ------------------------------------------------------
    def run_cycle(self, catalog: Catalog,
                  tables: Optional[Sequence] = None) -> CycleReport:
        """One cycle, recorded (:mod:`repro_torch.obs`, when on) as an
        ``autocomp.cycle`` span over ``autocomp.observe``, ``orient``,
        ``decide`` and ``act``; ``wall_s`` is that span's length."""
        t0 = obs.now()
        cycle = obs.begin("autocomp.cycle", start=t0)
        rep = CycleReport()
        try:
            ranked = self.propose(catalog, tables=tables, report=rep)

            with obs.span("autocomp.decide"):
                selected = self.decide.select(ranked)
                rep.n_selected = len(selected)
                rep.n_unpriced = len(getattr(self.decide, "last_unpriced",
                                             ()))
                rep.selected_keys = [c.key for c in selected]

            if self.act is not None:
                with obs.span("autocomp.act"):
                    rep.act = self.act.execute(selected)
                    rep.deferred_keys = [c.key for c in rep.act.deferred]

            # feedback loop -> observe (updated file counts / layout changes)
            if self.feedback_fn is not None and rep.act is not None:
                self.feedback_fn(rep)
        finally:
            t1 = obs.now()
            obs.end(cycle, t1)
        rep.wall_s = (t1 - t0) * 1e-9
        return rep
