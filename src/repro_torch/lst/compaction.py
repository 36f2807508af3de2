"""Bin-pack compaction execution (Iceberg's rewriteDataFiles analogue).

``plan_binpack`` groups undersized files into bins of ~target size;
``execute_task`` rewrites one bin: read inputs (metered), merge content
through a pluggable ``merge_fn`` (token shards use the kernel-backed packer
in repro_torch.data), write output(s), and commit a ``replace`` snapshot with
retry-on-conflict. Supports partial progress (per-bin commits) — FR1's
fine-grained work units — and failure injection for fault-tolerance tests.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.lst.files import DataFile
from repro_torch.lst.table import CommitConflict, LogStructuredTable


@dataclasses.dataclass
class CompactionTask:
    task_id: int
    table_id: str
    scope: Optional[str]                 # partition value or None (table scope)
    inputs: Tuple[DataFile, ...]
    est_output_bytes: int

    @property
    def input_bytes(self) -> int:
        return sum(f.size_bytes for f in self.inputs)


@dataclasses.dataclass
class CompactionResult:
    task: CompactionTask
    success: bool
    conflict: bool = False
    retries: int = 0
    files_removed: int = 0
    files_added: int = 0
    bytes_rewritten: int = 0
    rows_dropped: int = 0                # rows deleted by a filtered rewrite
    bytes_reclaimed: int = 0             # input bytes that left the table:
    gbhr: float = 0.0                    # dropped files + filtered-out rows
    error: Optional[str] = None


def plan_binpack(files: Sequence[DataFile], target_bytes: int,
                 min_input_files: int = 2,
                 scope: Optional[str] = None) -> List[CompactionTask]:
    """First-fit-decreasing bin packing of small files into ~target bins."""
    small = sorted((f for f in files if f.size_bytes < target_bytes),
                   key=lambda f: -f.size_bytes)
    bins: List[List[DataFile]] = []
    sizes: List[int] = []
    for f in small:
        for i, s in enumerate(sizes):
            if s + f.size_bytes <= target_bytes:
                bins[i].append(f)
                sizes[i] += f.size_bytes
                break
        else:
            bins.append([f])
            sizes.append(f.size_bytes)
    # Task IDs are scoped to the plan (1..N, bin order) — NFR2 determinism:
    # two plans over the same catalog state yield identical IDs, with no
    # module-global counter leaking state across tables or test runs.
    tasks = []
    for b, s in zip(bins, sizes):
        if len(b) >= min_input_files:
            tasks.append(CompactionTask(len(tasks) + 1, "", scope,
                                        tuple(b), s))
    return tasks


def plan_table(table: LogStructuredTable, target_bytes: int,
               scope: str = "table", min_input_files: int = 2
               ) -> List[CompactionTask]:
    """Plan tasks for a table at the given candidate scope.

    Execution ALWAYS respects partition boundaries (compaction never merges
    across partitions — §7); the scope only controls candidate granularity
    upstream. This is exactly why the paper's table-level ΔF_c estimator
    overestimates on partitioned tables: it counts small files across the
    whole table, while execution can only merge within each partition.
    """
    tasks: List[CompactionTask] = []
    for part in table.partitions() or [""]:
        files = [f for f in table.current_files()
                 if (f.partition or "") == part]
        for t in plan_binpack(files, target_bytes, min_input_files,
                              part or None):
            t.table_id = table.table_id
            t.task_id = len(tasks) + 1   # plan-scoped: unique across partitions
            tasks.append(t)
    return tasks


def default_merge_fn(table: LogStructuredTable, task: CompactionTask,
                     out_path: str, filter_fn: Optional[Callable] = None,
                     fused_filter: bool = True):
    """Synthetic merge: concatenates the raw payloads of the inputs.

    With ``filter_fn`` it models a rewrite-delete over synthetic rows: each
    input row is represented by a stable integer id (crc32 of its file path
    plus the row index, column 0 of the rows array), so a deterministic
    predicate — e.g. a GDPR-style hash match on the id — drops the same
    rows on every plan. Output payload, size and row count shrink to the
    kept fraction; returns ``(DataFile, rows_dropped)`` like the real
    token-shard merge. ``fused_filter`` is accepted for signature parity
    (there is no kernel here to fuse)."""
    blobs = [table.store.get(f.path) for f in task.inputs]
    data = b"".join(blobs)
    in_bytes = sum(f.size_bytes for f in task.inputs)
    n_rows = sum(f.num_rows for f in task.inputs)
    if filter_fn is None:
        table.store.put(out_path, data)
        return DataFile(path=out_path, size_bytes=in_bytes, num_rows=n_rows,
                        partition=task.scope, created_at=table.now_fn())
    import zlib

    import numpy as np
    ids = (np.concatenate(
        [zlib.crc32(f.path.encode()) + np.arange(f.num_rows, dtype=np.int64)
         for f in task.inputs])
        if n_rows else np.zeros((0,), np.int64))
    keep = np.asarray(filter_fn(ids.reshape(-1, 1), task), bool).reshape(-1)
    kept = int(keep.sum())
    frac = kept / n_rows if n_rows else 0.0
    out_bytes = int(round(in_bytes * frac))
    table.store.put(out_path, data[:out_bytes] if out_bytes else b"")
    out = DataFile(path=out_path, size_bytes=out_bytes, num_rows=kept,
                   partition=task.scope, created_at=table.now_fn())
    return out, n_rows - kept


def _merge_output(out) -> Tuple[DataFile, int]:
    """Normalize a merge_fn return: plain DataFile, or (DataFile,
    rows_dropped) from a filtered rewrite."""
    if isinstance(out, tuple):
        f, dropped = out
        return f, int(dropped)
    return out, 0


def _delete_orphans(table: LogStructuredTable,
                    written: Sequence[DataFile]) -> None:
    """Remove output blobs of a rewrite that never committed."""
    live = {f.path for f in table.current_files()}
    for f in written:
        if f.path not in live and table.store.exists(f.path):
            table.store.delete(f.path)


def execute_tasks_atomic(table: LogStructuredTable,
                         tasks: Sequence[CompactionTask],
                         merge_fn: Callable = default_merge_fn,
                         max_retries: int = 2,
                         executor_memory_gb: float = 8.0,
                         rewrite_bytes_per_hour: float = 256e9,
                         interleave_fn: Optional[Callable] = None,
                         filter_fn: Optional[Callable] = None,
                         fused_filter: bool = True
                         ) -> CompactionResult:
    """Table-scope execution: ALL bins of a candidate rewritten in ONE
    commit (Iceberg's default rewriteDataFiles). The conflict window spans
    the whole rewrite — this is why the paper's table-scope runs hit
    cluster-side conflicts that partition-scope (per-partition commits)
    avoids.

    ``filter_fn`` turns the rewrite into rewrite-deletes-as-compaction:
    it is forwarded to the merge_fn (with ``fused_filter`` selecting the
    fused filter+pack kernel vs the filter-then-pack reference), rows it
    drops never land in the outputs, and the per-bin drop counts sum into
    ``rows_dropped``."""
    agg = CompactionTask(0, table.table_id, None,
                         tuple(f for t in tasks for f in t.inputs),
                         sum(t.est_output_bytes for t in tasks))
    res = CompactionResult(task=agg, success=False)
    if not tasks:
        res.success = True
        return res
    txn = table.new_transaction()       # plan-time basis for the whole job
    merge_kwargs = {} if filter_fn is None else \
        {"filter_fn": filter_fn, "fused_filter": fused_filter}
    new_files = []
    for t in tasks:
        ext = t.inputs[0].path.rsplit(".", 1)[-1] if t.inputs else "bin"
        # deterministic per catalog state (NFR2), unique across cycles:
        # the snapshot basis version advances with every commit
        out_path = (f"{table.table_id}/data/"
                    f"compacted-{txn.base_version}-{t.task_id}.{ext}")
        try:
            f, dropped = _merge_output(
                merge_fn(table, t, out_path, **merge_kwargs))
            new_files.append(f)
            res.rows_dropped += dropped
        except FileNotFoundError as e:
            res.error = f"missing input: {e}"
            _delete_orphans(table, new_files)
            return res
        if interleave_fn is not None:
            interleave_fn(table, t)
    for attempt in range(max_retries + 1):
        inputs_alive = {f.path for f in table.current_files()}
        live_inputs = [f for f in agg.inputs if f.path in inputs_alive]
        if attempt > 0 and len(live_inputs) < 2:
            # same guard as execute_task: a conflict that killed the inputs
            # must not resurrect their rows via the merged outputs. Known
            # limitation (matches Iceberg's file-granularity semantics and
            # execute_task): when >= 2 inputs stay live the merged outputs
            # still commit, and they were built from ALL planned inputs —
            # rows of an input deleted concurrently mid-rewrite survive
            # inside the compacted file even though the file-level delete
            # stands. Row-level reconciliation belongs to the merge_fn.
            res.error = "inputs no longer live after conflict"
            break
        try:
            txn.rewrite_files(live_inputs, new_files, scope=None)
            txn.commit()
            res.success = True
            break
        except CommitConflict:
            res.conflict = True
            res.retries = attempt + 1
            txn = table.new_transaction()
    if res.success:
        # Only the inputs OUR commit replaced count (and get their blobs
        # dropped): ``live_inputs`` is exactly what the successful
        # transaction removed. The old accounting re-scanned liveness
        # *after* the commit and credited every planned input that was
        # gone — including files concurrent writers deleted — and worse,
        # deleted the blobs of inputs that were already dead at commit
        # time (another committer's files to clean, possibly still
        # referenced by its snapshots). Mirrors execute_task's
        # ``len(live_inputs)``.
        for f in live_inputs:
            if table.store.exists(f.path):
                table.store.delete(f.path)
        res.files_removed = len(live_inputs)
        res.files_added = len(new_files)
        res.bytes_rewritten = sum(f.size_bytes for f in live_inputs)
        if filter_fn is not None:
            res.bytes_reclaimed = max(0, res.bytes_rewritten
                                      - sum(f.size_bytes for f in new_files))
        res.gbhr = executor_memory_gb * (res.bytes_rewritten
                                         / rewrite_bytes_per_hour)
    else:
        # a compaction system must not create small-file garbage: drop the
        # already-written outputs of an uncommitted rewrite
        _delete_orphans(table, new_files)
        res.rows_dropped = 0             # nothing committed, nothing deleted
        if res.error is None:
            res.error = (f"retries exhausted after {res.retries} "
                         f"conflicting commit attempts")
    return res


def execute_task(table: LogStructuredTable, task: CompactionTask,
                 merge_fn: Callable = default_merge_fn,
                 max_retries: int = 2,
                 executor_memory_gb: float = 8.0,
                 rewrite_bytes_per_hour: float = 256e9,
                 fail_fn: Optional[Callable[[CompactionTask], bool]] = None,
                 interleave_fn: Optional[Callable] = None,
                 filter_fn: Optional[Callable] = None,
                 fused_filter: bool = True
                 ) -> CompactionResult:
    """Rewrite one bin and commit.

    Faithful long-running-job semantics: the rewrite TRANSACTION is opened at
    plan time (before the merge work), so concurrent commits that land while
    the rewrite runs trigger conflict validation at commit — the §4.4/§6.2
    behavior. ``interleave_fn(table)`` (tests/benchmarks) injects concurrent
    work into that window. Retries re-open a fresh-basis transaction.

    ``filter_fn`` (forwarded to merge_fn, with ``fused_filter`` choosing
    the fused filter+pack kernel vs the two-pass reference) makes this a
    rewrite-deletes-as-compaction: dropped rows are counted in
    ``rows_dropped`` and never written to the output.
    """
    res = CompactionResult(task=task, success=False)
    if fail_fn is not None and fail_fn(task):
        res.error = "injected_failure"
        return res
    ext = task.inputs[0].path.rsplit(".", 1)[-1] if task.inputs else "bin"
    txn = table.new_transaction()       # plan-time snapshot basis
    # deterministic per catalog state (NFR2), unique across cycles: the
    # snapshot basis version advances with every commit
    out_path = (f"{table.table_id}/data/"
                f"compacted-{txn.base_version}-{task.task_id}.{ext}")
    merge_kwargs = {} if filter_fn is None else \
        {"filter_fn": filter_fn, "fused_filter": fused_filter}
    try:
        new_file, res.rows_dropped = _merge_output(
            merge_fn(table, task, out_path, **merge_kwargs))
    except FileNotFoundError as e:
        res.error = f"missing input: {e}"
        _delete_orphans(table, [DataFile(out_path, 0, 0, task.scope)])
        return res
    if interleave_fn is not None:
        interleave_fn(table, task)      # concurrent user work mid-rewrite
    inputs_alive = {f.path for f in table.current_files()}
    live_inputs = [f for f in task.inputs if f.path in inputs_alive]
    for attempt in range(max_retries + 1):
        try:
            txn.rewrite_files(live_inputs, [new_file], scope=task.scope)
            txn.commit()
            res.success = True
            break
        except CommitConflict:
            res.conflict = True
            res.retries = attempt + 1
            inputs_alive = {f.path for f in table.current_files()}
            live_inputs = [f for f in task.inputs if f.path in inputs_alive]
            txn = table.new_transaction()   # fresh basis for the retry
            if len(live_inputs) < 2:
                res.error = "inputs no longer live after conflict"
                break
    if res.success:
        # physical cleanup of the files OUR commit replaced; inputs a
        # concurrent writer already removed are its blobs to clean
        for f in live_inputs:
            if table.store.exists(f.path):
                table.store.delete(f.path)
        res.files_removed = len(live_inputs)
        res.files_added = 1
        res.bytes_rewritten = sum(f.size_bytes for f in live_inputs)
        if filter_fn is not None:
            res.bytes_reclaimed = max(0, res.bytes_rewritten
                                      - new_file.size_bytes)
        # paper §4.2: GBHr_c = ExecutorMemoryGB * DataSize_c / RewriteBytesPerHour
        res.gbhr = executor_memory_gb * (res.bytes_rewritten
                                         / rewrite_bytes_per_hour)
    else:
        # aborted rewrite (conflict-dead inputs or exhausted retries): the
        # merged blob never entered table metadata — delete it, a compaction
        # system must not create small-file garbage
        _delete_orphans(table, [new_file])
        res.rows_dropped = 0             # nothing committed, nothing deleted
        if res.error is None:
            res.error = (f"retries exhausted after {res.retries} "
                         f"conflicting commit attempts")
    return res
