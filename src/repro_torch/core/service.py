"""AutoCompService: the standalone control-plane service (§5, Fig. 5).

Runs the OODA pipeline either
  * periodically ("pull": evaluate the whole catalog every interval), or
  * on write notifications ("push": optimize-after-write hooks mark tables
    dirty; the service recalculates only those candidates within budget).

Also owns the production rollout policy from §7: fixed top-k during rollout,
then dynamic k constrained by the compaction budget (select_budget).

The service drives any *planner* exposing ``run_cycle(catalog, tables=...)``
— a single ``AutoCompPipeline`` (one pool) or a
``core.fleet.FleetScheduler`` (cross-table decide/act over many per-class
pipelines under a shared budget); their reports are shape-compatible.
Candidates the act phase deferred (e.g. a closed off-peak window) are
requeued: their tables re-enter the next cycle's pool even in
``after_write`` mode where only dirty tables are normally re-evaluated.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set

from repro_torch.core.ooda import AutoCompPipeline, CycleReport
from repro_torch.core.triggers import OptimizeAfterWriteHook, PeriodicTrigger
from repro_torch.lst.catalog import Catalog


@dataclasses.dataclass
class ServiceConfig:
    interval_hours: float = 24.0          # daily, as deployed at LinkedIn
    mode: str = "periodic"                # "periodic" | "after_write" | "both"
    dynamic_k: bool = False               # §7: fixed k -> budget-driven k


class AutoCompService:
    def __init__(self, catalog: Catalog, pipeline,
                 config: ServiceConfig, now_fn: Callable[[], float]) -> None:
        self.catalog = catalog
        # "pipeline" is any cycle planner: AutoCompPipeline or FleetScheduler
        self.pipeline = pipeline
        self.config = config
        self.trigger = PeriodicTrigger(config.interval_hours, now_fn)
        self.hook: Optional[OptimizeAfterWriteHook] = None
        if config.mode in ("after_write", "both"):
            self.hook = OptimizeAfterWriteHook(catalog)
        self.reports: List = []
        # table_ids whose selected candidates were deferred by act last
        # cycle (closed off-peak window): requeued next cycle instead of
        # silently vanishing
        self._requeue: Set[str] = set()

    def tick(self):
        """Call regularly (e.g. once per simulated hour). Runs a cycle when
        due; returns its report (CycleReport / FleetCycleReport)."""
        if not self.trigger.should_fire():
            return None
        self.trigger.mark_fired()
        tables = None
        if self.hook is not None and self.config.mode == "after_write":
            due = self.hook.drain_dirty() | self._requeue
            tables = [t for t in self.catalog.tables()
                      if t.table_id in due]
        rep = self.pipeline.run_cycle(self.catalog, tables=tables)
        self._requeue = {k[0] for k in getattr(rep, "deferred_keys", ())}
        self.reports.append(rep)
        return rep

    # aggregate telemetry for Fig. 10-style reporting
    def totals(self) -> Dict[str, float]:
        return {
            "cycles": len(self.reports),
            "files_removed": sum(r.files_removed for r in self.reports),
            "gbhr": sum(r.gbhr for r in self.reports),
            "conflicts": sum(r.act.conflicts for r in self.reports if r.act),
            "failures": sum(r.act.failures for r in self.reports if r.act),
            "deferred": sum(len(getattr(r, "deferred_keys", ()))
                            for r in self.reports),
        }
