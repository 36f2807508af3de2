"""Execution triggers (§5): periodic ("pull") and optimize-after-write
("push").

Optimize-after-write supports both variants from the paper:
  * immediate: if a trait crosses its threshold right after a write, run
    compaction for that candidate now (unconstrained-budget regime);
  * decoupled: the hook only marks the candidate dirty; the standalone
    service recalculates traits and schedules within its budget.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core.decide import ThresholdPolicy
from repro_torch.core.model import Candidate, Scope
from repro_torch.lst.catalog import Catalog
from repro_torch.lst.table import LogStructuredTable


@dataclasses.dataclass
class PeriodicTrigger:
    """Fire every ``interval_hours`` of logical time."""
    interval_hours: float
    now_fn: Callable[[], float]
    last_fired: float = float("-inf")

    def should_fire(self) -> bool:
        return (self.now_fn() - self.last_fired) >= self.interval_hours

    def mark_fired(self) -> None:
        self.last_fired = self.now_fn()


class OptimizeAfterWriteHook:
    """Engine-side hook: registered as a catalog write listener."""

    def __init__(self, catalog: Catalog,
                 policy: Optional[ThresholdPolicy] = None,
                 observe_fn: Optional[Callable] = None,
                 immediate_fn: Optional[Callable] = None) -> None:
        self.catalog = catalog
        self.policy = policy
        self.observe_fn = observe_fn      # candidate -> stats+traits
        self.immediate_fn = immediate_fn  # candidate -> compact now
        self.dirty: Set[str] = set()
        self.fired: List[str] = []
        catalog.add_write_listener(self.on_write)

    def on_write(self, table: LogStructuredTable) -> None:
        self.dirty.add(table.table_id)
        if self.policy is None or self.observe_fn is None:
            return
        cand = Candidate(table, Scope.TABLE)
        self.observe_fn(cand)
        if self.policy.triggered(cand):
            self.fired.append(table.table_id)
            if self.immediate_fn is not None:
                self.immediate_fn(cand)

    def drain_dirty(self) -> Set[str]:
        d, self.dirty = self.dirty, set()
        return d
