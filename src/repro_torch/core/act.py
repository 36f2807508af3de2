"""Act phase (§4.4): schedule and execute selected compaction candidates.

Scheduling policies learned from the paper's deployment:
  * parallel across tables, sequential within a table (concurrent compaction
    of distinct partitions of one table conflicts under Iceberg v1.2);
  * optional off-peak window;
  * per-task retry with fresh snapshot basis on conflict;
  * can run on a dedicated "compaction cluster" (here: a worker pool
    decoupled from the training/query path).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.model import Candidate, Scope
from repro_torch.lst import compaction as comp
from repro_torch.lst import retention as ret
from repro_torch.lst.compaction import CompactionResult, CompactionTask


@dataclasses.dataclass
class ActReport:
    results: List[CompactionResult] = dataclasses.field(default_factory=list)
    # candidates selected by decide but NOT executed this call (e.g. the
    # off-peak window was closed) — reported so the caller can requeue them
    # next cycle instead of silently losing the selection
    deferred: List[Candidate] = dataclasses.field(default_factory=list)

    @property
    def files_removed(self) -> int:
        return sum(r.files_removed for r in self.results)

    @property
    def files_added(self) -> int:
        return sum(r.files_added for r in self.results)

    @property
    def bytes_rewritten(self) -> int:
        return sum(r.bytes_rewritten for r in self.results)

    @property
    def gbhr(self) -> float:
        return sum(r.gbhr for r in self.results)

    @property
    def rows_dropped(self) -> int:
        return sum(r.rows_dropped for r in self.results)

    @property
    def bytes_reclaimed(self) -> int:
        return sum(r.bytes_reclaimed for r in self.results)

    @property
    def conflicts(self) -> int:
        return sum(1 for r in self.results if r.conflict)

    @property
    def failures(self) -> int:
        return sum(1 for r in self.results if not r.success)


class Scheduler:
    def __init__(self, target_file_bytes: int,
                 merge_fn: Callable = comp.default_merge_fn,
                 executor_memory_gb: float = 8.0,
                 rewrite_bytes_per_hour: float = 256e9,
                 offpeak_window: Optional[Callable[[], bool]] = None,
                 max_retries: int = 2,
                 fail_fn: Optional[Callable] = None,
                 interleave_fn: Optional[Callable] = None,
                 fused_filter: bool = True) -> None:
        self.target = target_file_bytes
        self.merge_fn = merge_fn
        self.executor_memory_gb = executor_memory_gb
        self.rewrite_bytes_per_hour = rewrite_bytes_per_hour
        self.offpeak_window = offpeak_window
        self.max_retries = max_retries
        self.fail_fn = fail_fn
        self.interleave_fn = interleave_fn  # concurrent-writer injection
        self.fused_filter = fused_filter    # rewrite-delete kernel choice

    @staticmethod
    def _tasks_for(cand: Candidate,
                   table_tasks: List[CompactionTask]) -> List[CompactionTask]:
        """Dispatch one table plan's bins to a candidate by partition."""
        if cand.scope == Scope.PARTITION and cand.partition is not None:
            return [t for t in table_tasks
                    if (t.scope or "") == (cand.partition or "")]
        return table_tasks

    def plan(self, cand: Candidate) -> List[CompactionTask]:
        scope = "partition" if cand.scope == Scope.PARTITION else "table"
        tasks = comp.plan_table(cand.table, self.target, scope=scope)
        return self._tasks_for(cand, tasks)

    def _execute_delete(self, cand: Candidate) -> List[CompactionResult]:
        """Delete-candidate dispatch (see ``lst.retention``): tier-1 file
        drops commit one zero-byte metadata snapshot; tier-2 files are
        binned and rewritten through the ordinary single-task commit path
        with the op's keep-mask filter attached (fused filter+pack by
        default, the two-pass reference with ``fused_filter=False``)."""
        route = cand.delete_route
        results: List[CompactionResult] = []
        if route.file_drops:
            results.append(ret.execute_file_drops(
                cand.table, route.file_drops, max_retries=self.max_retries,
                interleave_fn=self.interleave_fn))
        if route.rewrite_files:
            keep = route.op.filter_fn()
            for task in ret.plan_rewrite_delete(cand.table,
                                                route.rewrite_files,
                                                self.target):
                results.append(comp.execute_task(
                    cand.table, task, merge_fn=self.merge_fn,
                    max_retries=self.max_retries,
                    executor_memory_gb=self.executor_memory_gb,
                    rewrite_bytes_per_hour=self.rewrite_bytes_per_hour,
                    fail_fn=self.fail_fn, interleave_fn=self.interleave_fn,
                    filter_fn=keep, fused_filter=self.fused_filter))
        return results

    def execute(self, selected: Sequence[Candidate]) -> ActReport:
        """Tables are independent units (parallelizable); within a table,
        tasks run sequentially to avoid LST conflicts (§4.4/§6).

        Planning is linear in the candidate count: each table is
        bin-packed ONCE per ``execute`` call and the resulting bins are
        dispatched to partition-scope candidates by partition (execution
        never crosses partitions, so compacting one partition leaves every
        other partition's bins valid). The old path re-ran
        ``comp.plan_table`` over the whole table for every partition
        candidate and filtered — O(P^2) bins planned for P partitions.
        Before executing a candidate, its dispatched bins are checked
        against CURRENT file liveness: if any bin references a file no
        longer live — consumed by an earlier candidate in this call, or
        deleted by a concurrent writer since planning — the table is
        replanned instead of executing the stale bin (which would merge a
        logically-deleted file's rows into the compacted output). The
        common case (distinct partitions, no concurrent deletes) still
        plans once: a liveness set-check per candidate, not a bin-pack.
        """
        report = ActReport()
        if self.offpeak_window is not None and not self.offpeak_window():
            report.deferred = list(selected)
            return report
        by_table: Dict[str, List[Candidate]] = {}
        for c in selected:
            by_table.setdefault(c.table.table_id, []).append(c)
        for table_id in sorted(by_table):
            table_tasks: Optional[List[CompactionTask]] = None
            for cand in by_table[table_id]:
                if cand.delete_route is not None:
                    results = self._execute_delete(cand)
                    cand.delete_results = results  # type: ignore[attr-defined]
                    report.results.extend(results)
                    table_tasks = None   # table changed: replan later bins
                    continue
                tasks: List[CompactionTask] = []
                if table_tasks is not None:
                    tasks = self._tasks_for(cand, table_tasks)
                    live = {f.path for f in cand.table.current_files()}
                    if any(f.path not in live
                           for t in tasks for f in t.inputs):
                        table_tasks = None      # stale plan: files died
                if table_tasks is None:
                    table_tasks = comp.plan_table(cand.table, self.target)
                    tasks = self._tasks_for(cand, table_tasks)
                if cand.scope != Scope.PARTITION:
                    # table scope: one commit for the whole rewrite job
                    res = comp.execute_tasks_atomic(
                        cand.table, tasks, merge_fn=self.merge_fn,
                        max_retries=self.max_retries,
                        executor_memory_gb=self.executor_memory_gb,
                        rewrite_bytes_per_hour=self.rewrite_bytes_per_hour,
                        interleave_fn=self.interleave_fn)
                    report.results.append(res)
                    table_tasks = None   # table-scope rewrite: replan
                    continue
                for task in tasks:      # partition scope: per-partition commit
                    res = comp.execute_task(
                        cand.table, task, merge_fn=self.merge_fn,
                        max_retries=self.max_retries,
                        executor_memory_gb=self.executor_memory_gb,
                        rewrite_bytes_per_hour=self.rewrite_bytes_per_hour,
                        fail_fn=self.fail_fn,
                        interleave_fn=self.interleave_fn)
                    report.results.append(res)
        return report
