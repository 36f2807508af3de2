"""Log-structured-table metadata model (Iceberg-semantics).

A table version (Snapshot) references a *manifest list*, which references
*manifest files*, which reference immutable *data files*. Every metadata
object is itself persisted through the ObjectStore, so metadata churn
contributes to small-file proliferation exactly as §2 of the paper describes
("Iceberg introduces additional metadata ... This added metadata contributes
to small file proliferation").
"""

from __future__ import annotations

import dataclasses
import json
import operator
from typing import Any, Dict, List, Optional, Tuple

from repro_torch import obs


@dataclasses.dataclass(frozen=True)
class DataFile:
    path: str
    size_bytes: int
    num_rows: int
    partition: Optional[str] = None      # partition key value ("" = unpartitioned)
    created_at: float = 0.0              # logical time
    min_key: Optional[int] = None
    max_key: Optional[int] = None

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "DataFile":
        return DataFile(**d)


@dataclasses.dataclass(frozen=True)
class ManifestFile:
    path: str
    added: Tuple[DataFile, ...] = ()
    removed: Tuple[str, ...] = ()        # removed data-file paths

    def serialize(self) -> bytes:
        return json.dumps({
            "added": [f.to_json() for f in self.added],
            "removed": list(self.removed),
        }).encode()

    @staticmethod
    def deserialize(path: str, raw: bytes) -> "ManifestFile":
        d = json.loads(raw.decode())
        return ManifestFile(path,
                            tuple(DataFile.from_json(f) for f in d["added"]),
                            tuple(d["removed"]))


@dataclasses.dataclass(frozen=True)
class Snapshot:
    snapshot_id: int
    parent_id: Optional[int]
    sequence_number: int
    timestamp: float
    operation: str                       # append | delete | overwrite | replace
    manifest_list_path: str
    summary: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Snapshot":
        return Snapshot(**d)


@dataclasses.dataclass
class TableMetadata:
    table_id: str
    partition_spec: Optional[str]        # name of the partition column (or None)
    properties: Dict[str, Any]
    snapshots: List[Snapshot]
    current_snapshot_id: Optional[int]
    version: int = 0
    created_at: float = 0.0
    last_write_at: float = 0.0

    def __post_init__(self) -> None:
        # the snapshots last serialized, in order, and their JSON; not
        # fields, so ``dataclasses.asdict`` and ``==`` never see them
        self._encoded: List[Snapshot] = []
        self._fragments: List[str] = []

    def current(self) -> Optional[Snapshot]:
        for s in self.snapshots:
            if s.snapshot_id == self.current_snapshot_id:
                return s
        return None

    def serialize(self) -> bytes:
        """``json.dumps(dataclasses.asdict(self)).encode()``, byte for
        byte, with each snapshot's JSON encoded once while ``snapshots``
        only grows: a commit encodes its own snapshot and the header, not
        the table's history. Counted (when
        :mod:`repro_torch.obs` is on) as ``lst.meta.snapshots_written``
        (entries written) and ``lst.meta.snapshots_encoded`` (entries
        encoded anew)."""
        snaps, done = self.snapshots, self._encoded
        if len(done) > len(snaps) or not all(map(operator.is_, snaps, done)):
            # not the last list grown by appends (expiry dropped its
            # head): encode it whole, so no fragment outlives its snapshot
            done, self._fragments = [], []
        encoded = len(snaps) - len(done)
        # a committed snapshot is frozen and nothing mutates its summary,
        # so its JSON stays what it was encoded as
        self._fragments += [json.dumps(s.to_json())
                            for s in snaps[len(done):]]
        self._encoded = list(snaps)
        frags = self._fragments
        obs.count("lst.meta.snapshots_written", len(frags))
        obs.count("lst.meta.snapshots_encoded", encoded)
        parts = []
        for f in dataclasses.fields(self):
            value = "[" + ", ".join(frags) + "]" if f.name == "snapshots" \
                else json.dumps(getattr(self, f.name))
            parts.append(f"{json.dumps(f.name)}: {value}")
        return ("{" + ", ".join(parts) + "}").encode()
