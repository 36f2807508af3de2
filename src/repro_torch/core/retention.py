"""Fleet-side retention queue: pending delete ops become pool candidates.

The LST layer (``lst.retention``) knows how to ROUTE and EXECUTE a delete;
this module decides WHEN, by turning pending operations into priced
``Candidate``s that compete in the ``FleetScheduler`` pool against ordinary
compaction — same min-max normalization, same query-frequency weighting,
same starvation bound, same shared GBHr budget. One candidate per
(operation, table) carries the routed ``DeleteRoute`` and three traits:

  compute_cost   GBHr of the tier-2 rewrite bytes (the paper's §4.2 cost
                 model). A pure file-drop candidate costs an EXPLICIT 0.0 —
                 priced-free, budget-admissible, never conservative-skipped
                 as unpriced: dropping metadata entries rewrites nothing.
  reclaim_bytes  dropped-file bytes + est_selectivity x rewrite bytes; the
                 benefit term ``decide.pooled_benefit`` adds to file-count
                 reduction so drop-heavy candidates can win the budget.
  file_count_reduction  files that leave the table (drops + binning).

Lifecycle: ``RetentionPolicy`` is STANDING — re-routed every cycle, a
candidate appears whenever files currently age out, and an empty route just
means nothing to do this cycle. ``PredicateDelete`` is ONE-SHOT — it stays
pending (surviving deferral, conflicts, and service requeues) until its
rewrite fully succeeds on a table, then ``note_executed`` retires that
(op, table) pair; the op itself is dropped once every target table is done.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.model import Candidate, CandidateStats, Scope
from repro_torch.lst.retention import PredicateDelete, route_delete

MB = 1 << 20


class RetentionQueue:
    def __init__(self, target_file_bytes: int = 512 * MB,
                 executor_memory_gb: float = 8.0,
                 rewrite_bytes_per_hour: float = 256e9) -> None:
        self.target_file_bytes = target_file_bytes
        self.executor_memory_gb = executor_memory_gb
        self.rewrite_bytes_per_hour = rewrite_bytes_per_hour
        self.ops: List = []                       # pending, submission order
        self._done: Set[Tuple[str, str]] = set()  # finished (op.name, table)

    # ------------------------------------------------------------- lifecycle
    def submit(self, op) -> None:
        """Queue a RetentionPolicy or PredicateDelete (idempotent by name:
        resubmitting a name replaces the old op and resets its progress)."""
        self.ops = [o for o in self.ops if o.name != op.name]
        self._done = {d for d in self._done if d[0] != op.name}
        self.ops.append(op)

    def has_pending(self) -> bool:
        return bool(self.ops)

    def _op_pending_for(self, op, table_id: str) -> bool:
        return op.applies_to(table_id) and \
            (op.name, table_id) not in self._done

    def note_executed(self, cand: Candidate) -> None:
        """Called by the fleet after act: a one-shot op is done for this
        table once every routed result committed. Standing policies are
        never retired — next cycle re-routes whatever newly aged out."""
        route = cand.delete_route
        results = getattr(cand, "delete_results", [])
        if (isinstance(route.op, PredicateDelete) and results
                and all(r.success for r in results)):
            self._done.add((route.op.name, cand.table.table_id))
            self._gc(route.op)

    def _gc(self, op) -> None:
        """Drop a one-shot op once all its (known) target tables are done;
        fleet-wide ops (tables=None) stay queued — the done-set keeps their
        finished tables out of propose()."""
        if getattr(op, "tables", None) and all(
                (op.name, tid) in self._done for tid in op.tables):
            self.ops.remove(op)

    # --------------------------------------------------------------- propose
    def target_tables(self, catalog) -> List:
        """Tables with a pending op — so an after_write fleet cycle (which
        only looks at dirty tables) still sees retention work on tables
        nobody is writing to."""
        if not self.ops:
            return []
        return [t for t in sorted(catalog.tables(), key=lambda t: t.table_id)
                if any(self._op_pending_for(op, t.table_id)
                       for op in self.ops)]

    def propose(self, tables: Sequence, activity=None,
                now: Optional[float] = None) -> List[Candidate]:
        """Route every pending op against every applicable table and emit
        one priced candidate per non-empty route. Deterministic: tables
        sorted by id, ops in submission order (NFR2)."""
        cands: List[Candidate] = []
        for t in sorted(tables, key=lambda t: t.table_id):
            for op in list(self.ops):
                if not self._op_pending_for(op, t.table_id):
                    continue
                route = route_delete(t, op, now)
                if route.empty:
                    if isinstance(op, PredicateDelete):
                        # nothing routable (e.g. empty table): one-shot done
                        self._done.add((op.name, t.table_id))
                        self._gc(op)
                    continue
                cands.append(self._candidate(t, route, activity))
        return cands

    def _candidate(self, table, route, activity) -> Candidate:
        files = table.current_files()
        stats = CandidateStats(
            file_count=len(files),
            total_bytes=sum(f.size_bytes for f in files),
            small_file_count=0, small_bytes=0, size_histogram=(),
            partition_count=len({f.partition or "" for f in files}),
            created_at=table.meta.created_at,
            last_write_at=table.meta.last_write_at)
        if activity is not None:
            stats.custom["query_freq"] = activity.read_rate(table.table_id)
        c = Candidate(table, Scope.TABLE, stats=stats, delete_route=route)
        sel = getattr(route.op, "est_selectivity", 0.0)
        n_rw = len(route.rewrite_files)
        est_out = 0 if n_rw == 0 else min(n_rw, max(1, math.ceil(
            route.rewrite_bytes * (1.0 - sel) / self.target_file_bytes)))
        c.traits["file_count_reduction"] = float(
            len(route.file_drops) + (n_rw - est_out))
        c.traits["reclaim_bytes"] = float(route.est_reclaim_bytes)
        # §4.2 GBHr over the REWRITTEN bytes only; file drops move none
        c.traits["compute_cost"] = (self.executor_memory_gb
                                    * route.rewrite_bytes
                                    / self.rewrite_bytes_per_hour)
        return c
