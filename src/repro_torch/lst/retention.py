"""Tiered DELETE/retention for log-structured tables.

Two delete tiers, one router. The LSM design-space literature treats data
removal as a first-class compaction primitive, and tombstone-based deletes
are the main read-amplification hazard log-structured tables face — so this
layer never writes a tombstone. Every delete resolves to one of:

  file-level drop   the predicate aligns with file/partition boundaries
                    (time-based retention on immutable files, explicit
                    partition drops, predicates that provably match every
                    row of a file). A pure METADATA commit: a ``delete``
                    snapshot removes the entries, zero bytes are rewritten,
                    and the commit validates against concurrent writers
                    exactly like compaction's atomic path — liveness is
                    re-checked per attempt, and a blob is physically
                    deleted only if OUR commit removed its entry and no
                    concurrent commit re-referenced the path.

  rewrite-delete    sparse predicates (GDPR erasure, tag-scoped cleanup):
                    the files that MAY contain matching rows are rewritten
                    with a filter attached — a rewrite that drops rows is
                    just a compaction with a filter, so it reuses
                    ``compaction.execute_task(filter_fn=)`` and the fused
                    filter+pack kernel. ``core.retention.RetentionQueue``
                    prices these into the fleet scheduler's shared GBHr
                    budget instead of running them as ad-hoc jobs.

``route_delete`` is the router; ``execute_file_drops`` the tier-1 executor
(returns a ``CompactionResult`` with ``bytes_rewritten == 0`` so the act
layer aggregates both tiers uniformly); ``plan_rewrite_delete`` bins the
tier-2 files into compaction tasks (unlike ``plan_binpack`` it takes every
matched file regardless of size and allows single-file bins — a 600 MB
file with matching rows still has to be rewritten).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.lst.compaction import CompactionResult, CompactionTask
from repro_torch.lst.files import DataFile
from repro_torch.lst.table import CommitConflict, LogStructuredTable


@dataclasses.dataclass(frozen=True)
class RetentionPolicy:
    """Time/partition-aligned retention: a STANDING policy, re-routed every
    cycle — each cycle drops whatever newly aged out. Both predicates are
    file-aligned by construction (files are immutable and carry their
    ``created_at``; partitions are file attributes), so a retention policy
    always routes to tier-1 file drops and never rewrites a byte."""
    name: str
    max_age_hours: Optional[float] = None     # drop files older than this
    drop_partitions: Tuple[str, ...] = ()     # explicit partition drops
    tables: Optional[Tuple[str, ...]] = None  # table_ids; None = all

    def applies_to(self, table_id: str) -> bool:
        return self.tables is None or table_id in self.tables

    def matches_file(self, f: DataFile, now: float) -> bool:
        if (f.partition or "") in self.drop_partitions:
            return True
        return (self.max_age_hours is not None
                and now - f.created_at >= self.max_age_hours)


@dataclasses.dataclass(frozen=True)
class PredicateDelete:
    """Row-level delete (GDPR/tag-scoped): ONE-SHOT — pending until every
    target table's rewrite commits, then retired by the queue.

    ``row_predicate(rows, task) -> drop_mask`` marks rows to DELETE (the
    natural polarity for a delete job); :meth:`filter_fn` adapts it to the
    keep-mask contract of ``execute_task(filter_fn=)``. ``file_predicate``
    lets file-level metadata short-circuit the row scan per file:
    ``True`` = every row matches (tier-1 drop, no rewrite), ``False`` = no
    row can match (skip entirely), ``None`` = unknown (tier-2 rewrite).
    ``est_selectivity`` is the expected dropped-row fraction of the files
    that need rewriting — it prices the candidate's reclaimed bytes before
    any byte is read."""
    name: str
    row_predicate: Callable = None            # (rows, task) -> bool drop mask
    file_predicate: Optional[Callable] = None  # DataFile -> True|False|None
    est_selectivity: float = 0.1
    tables: Optional[Tuple[str, ...]] = None

    def applies_to(self, table_id: str) -> bool:
        return self.tables is None or table_id in self.tables

    def filter_fn(self) -> Callable:
        """Keep-mask adapter for the compaction substrate."""
        def keep(rows, task):
            drop = np.asarray(self.row_predicate(rows, task), bool)
            return ~drop.reshape(-1)
        return keep


@dataclasses.dataclass
class DeleteRoute:
    """Router output for one (op, table): which files drop at the metadata
    tier and which must be rewritten with the filter attached."""
    op: object                                # RetentionPolicy | PredicateDelete
    table_id: str
    file_drops: Tuple[DataFile, ...] = ()
    rewrite_files: Tuple[DataFile, ...] = ()

    @property
    def empty(self) -> bool:
        return not self.file_drops and not self.rewrite_files

    @property
    def drop_bytes(self) -> int:
        return sum(f.size_bytes for f in self.file_drops)

    @property
    def drop_rows(self) -> int:
        return sum(f.num_rows for f in self.file_drops)

    @property
    def rewrite_bytes(self) -> int:
        return sum(f.size_bytes for f in self.rewrite_files)

    @property
    def rewrite_rows(self) -> int:
        return sum(f.num_rows for f in self.rewrite_files)

    @property
    def est_reclaim_bytes(self) -> float:
        """Priced benefit: dropped files reclaim everything; rewrites
        reclaim their estimated selectivity."""
        sel = getattr(self.op, "est_selectivity", 0.0)
        return self.drop_bytes + sel * self.rewrite_bytes


def route_delete(table: LogStructuredTable, op,
                 now: Optional[float] = None) -> DeleteRoute:
    """Decide, per current file, which tier serves it.

    Decision table (see ``lst/README.md`` for worked examples):

      op kind           file evidence                     tier
      ----------------  --------------------------------  -----------------
      RetentionPolicy   partition in drop_partitions      file-level drop
      RetentionPolicy   created_at older than max_age     file-level drop
      RetentionPolicy   neither                           keep (no action)
      PredicateDelete   file_predicate(f) is True         file-level drop
      PredicateDelete   file_predicate(f) is False        keep (no action)
      PredicateDelete   file_predicate(f) is None / unset rewrite-delete
    """
    now = table.now_fn() if now is None else now
    drops: List[DataFile] = []
    rewrites: List[DataFile] = []
    for f in table.current_files():
        if isinstance(op, RetentionPolicy):
            if op.matches_file(f, now):
                drops.append(f)
            continue
        verdict = op.file_predicate(f) if op.file_predicate is not None \
            else None
        if verdict is True:
            drops.append(f)
        elif verdict is None:
            rewrites.append(f)
    return DeleteRoute(op=op, table_id=table.table_id,
                       file_drops=tuple(drops), rewrite_files=tuple(rewrites))


def plan_rewrite_delete(table: LogStructuredTable,
                        files: Sequence[DataFile],
                        target_bytes: int) -> List[CompactionTask]:
    """Bin the tier-2 files into rewrite tasks. Execution never crosses
    partitions (same rule as compaction); every matched file is planned —
    no small-file cutoff, single-file bins allowed, an over-target file
    gets its own bin. Task IDs are plan-scoped (NFR2)."""
    by_part = {}
    for f in files:
        by_part.setdefault(f.partition or "", []).append(f)
    tasks: List[CompactionTask] = []
    for part in sorted(by_part):
        group = sorted(by_part[part], key=lambda f: (-f.size_bytes, f.path))
        bins: List[List[DataFile]] = []
        sizes: List[int] = []
        for f in group:
            for i, s in enumerate(sizes):
                if s + f.size_bytes <= target_bytes:
                    bins[i].append(f)
                    sizes[i] += f.size_bytes
                    break
            else:
                bins.append([f])
                sizes.append(f.size_bytes)
        for b, s in zip(bins, sizes):
            tasks.append(CompactionTask(len(tasks) + 1, table.table_id,
                                        part or None, tuple(b), s))
    return tasks


def execute_file_drops(table: LogStructuredTable,
                       files: Sequence[DataFile],
                       max_retries: int = 2,
                       interleave_fn: Optional[Callable] = None
                       ) -> CompactionResult:
    """Tier-1 executor: commit ONE ``delete`` snapshot removing the planned
    entries. Zero bytes rewritten, zero GBHr — the whole point of routing
    boundary-aligned deletes here.

    Concurrent-writer safety mirrors ``execute_tasks_atomic``'s live-input
    accounting: liveness is recomputed per commit attempt, so a file a
    concurrent writer already removed is neither counted as OUR removal nor
    physically deleted (its blob belongs to whoever removed it — possibly a
    compaction output still referencing those bytes). After the commit,
    blobs are deleted only for paths that are no longer referenced by the
    table: if a concurrent commit re-referenced a planned path between plan
    and commit, the entry is removed by our snapshot rebase but the BLOB
    survives for the re-referencing writer.
    """
    agg = CompactionTask(0, table.table_id, None, tuple(files), 0)
    res = CompactionResult(task=agg, success=False)
    if not files:
        res.success = True
        return res
    scopes = {f.partition or "" for f in files}
    scope = next(iter(scopes)) or None if len(scopes) == 1 else None
    txn = table.new_transaction()         # plan-time basis
    if interleave_fn is not None:
        interleave_fn(table, agg)         # the plan -> commit window
    live_inputs: List[DataFile] = []
    for attempt in range(max_retries + 1):
        # liveness is by ENTRY IDENTITY (path + generation), not path alone:
        # if a concurrent writer dropped a planned file and re-appended a
        # fresh entry at the same path, the planned file is gone — removing
        # the look-alike would delete data the writer just (re)committed
        alive = {(f.path, f.created_at, f.size_bytes)
                 for f in table.current_files()}
        live_inputs = [f for f in agg.inputs
                       if (f.path, f.created_at, f.size_bytes) in alive]
        if not live_inputs:
            # everything already gone (concurrent writers beat us to it):
            # vacuous success, nothing removed, nothing to clean
            res.success = True
            return res
        try:
            txn.remove_files(live_inputs, scope=scope)
            txn.commit()
            res.success = True
            break
        except CommitConflict:
            res.conflict = True
            res.retries = attempt + 1
            txn = table.new_transaction()  # fresh basis for the retry
    if res.success:
        # physical cleanup: only entries OUR commit removed, and only if no
        # later commit re-referenced the path
        still_live = {f.path for f in table.current_files()}
        for f in live_inputs:
            if f.path not in still_live and table.store.exists(f.path):
                table.store.delete(f.path)
        res.files_removed = len(live_inputs)
        res.bytes_rewritten = 0           # the tier-1 guarantee
        res.rows_dropped = sum(f.num_rows for f in live_inputs)
        res.bytes_reclaimed = sum(f.size_bytes for f in live_inputs)
        res.gbhr = 0.0
    else:
        res.error = (f"retries exhausted after {res.retries} "
                     f"conflicting commit attempts")
    return res
