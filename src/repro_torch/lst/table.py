"""LogStructuredTable: Iceberg-semantics table with optimistic concurrency.

Commit protocol: a Transaction captures the table version it was based on;
``commit()`` atomically swaps table metadata iff the version is unchanged,
otherwise it validates whether the concurrent commits conflict:

  * appends commute with anything (rebased automatically);
  * rewrites (compaction) conflict with concurrent commits that touched the
    same files — OR, under ``conflict_granularity="table"`` (the Iceberg
    v1.2.0 behavior observed in §4.4/§6.2 of the paper: "compaction
    operations executed concurrently could result in conflicts when
    targeting distinct partitions"), with ANY concurrent rewrite/delete on
    the table.

Raises CommitConflict when validation fails; callers (compaction scheduler,
write pipelines) implement retry policies, and Table 1 of the paper is
reproduced by counting these.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.lst.files import DataFile, ManifestFile, Snapshot, TableMetadata
from repro_torch.lst.storage import ObjectStore


class CommitConflict(Exception):
    def __init__(self, msg: str, kind: str = "conflict"):
        super().__init__(msg)
        self.kind = kind


def _logical_now() -> float:
    return time.monotonic()


class LogStructuredTable:
    def __init__(self, store: ObjectStore, table_id: str,
                 partition_spec: Optional[str] = None,
                 properties: Optional[Dict] = None,
                 now_fn=_logical_now) -> None:
        self.store = store
        self.now_fn = now_fn
        self.meta = TableMetadata(
            table_id=table_id, partition_spec=partition_spec,
            properties=dict(properties or {}), snapshots=[],
            current_snapshot_id=None, created_at=now_fn())
        self._files: Dict[int, Tuple[DataFile, ...]] = {}   # snapshot -> files
        self._lock = threading.RLock()
        self.cas_retries = 0    # commits that found a moved base (client retry)
        self._persist_metadata()

    # ------------------------------------------------------------------ props
    @property
    def table_id(self) -> str:
        return self.meta.table_id

    @property
    def conflict_granularity(self) -> str:
        return self.meta.properties.get("conflict_granularity", "table")

    @property
    def version(self) -> int:
        return self.meta.version

    # ------------------------------------------------------------------ reads
    def current_files(self, snapshot_id: Optional[int] = None
                      ) -> Tuple[DataFile, ...]:
        with self._lock:
            sid = snapshot_id if snapshot_id is not None \
                else self.meta.current_snapshot_id
            if sid is None:
                return ()
            return self._files[sid]

    def scan(self, partition: Optional[str] = None,
             snapshot_id: Optional[int] = None) -> List[DataFile]:
        """Plan a scan: reads manifest metadata (metered) + filters."""
        files = self.current_files(snapshot_id)
        snap = self.meta.current() if snapshot_id is None else \
            next(s for s in self.meta.snapshots if s.snapshot_id == snapshot_id)
        if snap is not None:           # metadata read cost: manifest list
            self.store.get(snap.manifest_list_path)
        if partition is None:
            return list(files)
        return [f for f in files if f.partition == partition]

    def partitions(self) -> List[str]:
        return sorted({f.partition or "" for f in self.current_files()})

    def file_count(self) -> int:
        return len(self.current_files())

    def total_bytes(self) -> int:
        return sum(f.size_bytes for f in self.current_files())

    # ------------------------------------------------------------ transactions
    def new_transaction(self) -> "Transaction":
        with self._lock:
            return Transaction(self, self.meta.version,
                               self.meta.current_snapshot_id)

    def append(self, files: Sequence[DataFile]) -> Snapshot:
        txn = self.new_transaction()
        txn.append_files(files)
        return txn.commit()

    def rewrite(self, removed: Sequence[DataFile], added: Sequence[DataFile],
                scope: Optional[str] = None) -> Snapshot:
        txn = self.new_transaction()
        txn.rewrite_files(removed, added, scope)
        return txn.commit()

    def delete_files(self, removed: Sequence[DataFile],
                     scope: Optional[str] = None) -> Snapshot:
        txn = self.new_transaction()
        txn.remove_files(removed, scope=scope)
        return txn.commit()

    # ------------------------------------------------------------ maintenance
    def expire_snapshots(self, keep_last: int = 5) -> int:
        """Drop old snapshot metadata + orphaned data files. Returns #objects
        removed (snapshot expiry is itself a storage-healing operation)."""
        with self._lock:
            if len(self.meta.snapshots) <= keep_last:
                return 0
            keep = self.meta.snapshots[-keep_last:]
            drop = self.meta.snapshots[:-keep_last]
            live: set = set()
            for s in keep:
                live |= {f.path for f in self._files[s.snapshot_id]}
            removed = 0
            for s in drop:
                for f in self._files.pop(s.snapshot_id, ()):
                    if f.path not in live and self.store.exists(f.path):
                        self.store.delete(f.path)
                        removed += 1
                self.store.delete(s.manifest_list_path)
                removed += 1
            self.meta.snapshots = keep
            self._persist_metadata()
            return removed

    # ------------------------------------------------------------- internals
    def _next_snapshot_id(self) -> int:
        """Per-table snapshot IDs, seeded from the table's own metadata.

        NFR2 determinism: a module-global counter (the old
        ``itertools.count``) leaks allocation order across every table in
        the process, so identical catalog states produced different
        snapshot IDs and manifest paths depending on what else had
        committed first. Deriving the next ID from the newest snapshot in
        ``self.meta`` makes IDs (and the metadata paths built from them) a
        pure function of table history — two identical runs serialize
        byte-identical metadata. Expiry only drops *old* snapshots, so the
        newest survives and IDs stay strictly increasing.
        """
        if self.meta.snapshots:
            return self.meta.snapshots[-1].snapshot_id + 1
        return 1

    def _persist_metadata(self) -> None:
        path = f"{self.meta.table_id}/metadata/v{self.meta.version}.json"
        self.store.put(path, self.meta.serialize())

    def _try_commit(self, txn: "Transaction") -> Snapshot:
        """Recorded (:mod:`repro_torch.obs`, when on) as ``lst.commit``
        over ``lst.commit.rebase`` (current files, conflict check, the new
        file tuple), ``lst.commit.manifest`` (the manifest and its list)
        and ``lst.commit.metadata`` (the table's metadata)."""
        with obs.span("lst.commit"), self._lock:
            with obs.span("lst.commit.rebase"):
                if self.meta.version != txn.base_version:
                    self.cas_retries += 1   # stale base: CAS retry happened
                    self._validate(txn)
                # rebase onto current state
                base = self.current_files()
                removed_paths = {f.path for f in txn.removed}
                if txn.operation in ("replace", "delete"):
                    missing = removed_paths - {f.path for f in base}
                    if missing:
                        raise CommitConflict(
                            "files vanished under rewrite: "
                            f"{sorted(missing)[:3]}", kind="stale_files")
                new_files = tuple(f for f in base
                                  if f.path not in removed_paths
                                  ) + tuple(txn.added)
            sid = self._next_snapshot_id()
            seq = (self.meta.snapshots[-1].sequence_number + 1
                   if self.meta.snapshots else 1)
            with obs.span("lst.commit.manifest"):
                manifest = ManifestFile(
                    f"{self.table_id}/metadata/manifest-{sid}.json",
                    tuple(txn.added), tuple(sorted(removed_paths)))
                self.store.put(manifest.path, manifest.serialize())
                mlist_path = f"{self.table_id}/metadata/snap-{sid}.json"
                self.store.put(mlist_path, json.dumps(
                    {"manifests": [manifest.path]}).encode())
            snap = Snapshot(
                snapshot_id=sid, parent_id=self.meta.current_snapshot_id,
                sequence_number=seq, timestamp=self.now_fn(),
                operation=txn.operation, manifest_list_path=mlist_path,
                summary={"added": len(txn.added),
                         "removed": len(removed_paths),
                         "scope": txn.scope})
            self.meta.snapshots.append(snap)
            self.meta.current_snapshot_id = sid
            self.meta.version += 1
            self.meta.last_write_at = snap.timestamp
            self._files[sid] = new_files
            with obs.span("lst.commit.metadata"):
                self._persist_metadata()
            return snap

    def _validate(self, txn: "Transaction") -> None:
        """Conflict validation against commits since txn.base_version."""
        later = [s for s in self.meta.snapshots
                 if txn.base_snapshot_id is None
                 or s.snapshot_id > (txn.base_snapshot_id or 0)]
        if txn.operation == "append":
            return                        # appends always rebase cleanly
        stale_thresh = int(self.meta.properties.get(
            "stale_metadata_threshold", 2))
        for s in later:
            if s.operation == "append":
                # Iceberg v1.2 behavior (§4.4/§6.2): a long-running rewrite
                # accumulating enough concurrent commits fails with a
                # stale-metadata conflict even though appends are logically
                # compatible — short (partition-scope) windows rarely hit
                # this, long table-scope jobs do
                if self.conflict_granularity == "table" \
                        and len(later) >= stale_thresh:
                    raise CommitConflict(
                        f"stale metadata: {len(later)} commits since rewrite "
                        f"basis", kind="stale_metadata")
                continue
            if self.conflict_granularity == "table":
                raise CommitConflict(
                    f"concurrent {s.operation} (snapshot {s.snapshot_id}) "
                    f"conflicts at table granularity", kind="table_granularity")
            if s.summary.get("scope") == txn.scope or s.summary.get("scope") \
                    is None or txn.scope is None:
                raise CommitConflict(
                    f"concurrent {s.operation} on scope {txn.scope!r}",
                    kind="partition_overlap")


class Transaction:
    def __init__(self, table: LogStructuredTable, base_version: int,
                 base_snapshot_id: Optional[int]) -> None:
        self.table = table
        self.base_version = base_version
        self.base_snapshot_id = base_snapshot_id
        self.added: List[DataFile] = []
        self.removed: List[DataFile] = []
        self.operation = "append"
        self.scope: Optional[str] = None

    def append_files(self, files: Sequence[DataFile]) -> "Transaction":
        self.added.extend(files)
        self.operation = "append"
        return self

    def remove_files(self, files: Sequence[DataFile],
                     scope: Optional[str] = None) -> "Transaction":
        """File-level delete. ``scope`` narrows the conflict window under
        partition granularity when every removed file shares one partition
        (a partition-aligned retention drop), exactly as rewrites do."""
        self.removed.extend(files)
        self.operation = "delete"
        self.scope = scope
        return self

    def rewrite_files(self, removed: Sequence[DataFile],
                      added: Sequence[DataFile],
                      scope: Optional[str] = None) -> "Transaction":
        self.removed.extend(removed)
        self.added.extend(added)
        self.operation = "replace"
        self.scope = scope
        return self

    def commit(self) -> Snapshot:
        return self.table._try_commit(self)
