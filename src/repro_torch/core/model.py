"""Data model shared by the OODA phases (§3.3, §4.1)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional, Tuple

from repro_torch.lst.files import DataFile
from repro_torch.lst.table import LogStructuredTable


class Scope(enum.Enum):
    TABLE = "table"
    PARTITION = "partition"
    SNAPSHOT = "snapshot"


@dataclasses.dataclass
class CandidateStats:
    """Output of the observe phase: generic statistics (§4.1) + custom."""
    file_count: int
    total_bytes: int
    small_file_count: int
    small_bytes: int
    size_histogram: Tuple[int, ...]          # counts per power-of-two bucket
    partition_count: int
    created_at: float
    last_write_at: float
    custom: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Candidate:
    """A collection of files to be compacted (§4.1): table, partition, or
    snapshot scoped. A candidate carrying a ``delete_route`` is a DELETE
    entering the pool (see ``core.retention``): its act dispatch drops/
    rewrites the routed files instead of bin-packing the scope."""
    table: LogStructuredTable
    scope: Scope
    partition: Optional[str] = None
    snapshot_id: Optional[int] = None
    stats: Optional[CandidateStats] = None
    traits: Dict[str, float] = dataclasses.field(default_factory=dict)
    normalized: Dict[str, float] = dataclasses.field(default_factory=dict)
    score: float = 0.0
    delete_route: Optional[Any] = None   # lst.retention.DeleteRoute

    @property
    def key(self) -> Tuple[str, str, str, str]:
        op = self.delete_route.op if self.delete_route is not None else None
        return (self.table.table_id, self.scope.value, self.partition or "",
                getattr(op, "name", ""))

    def files(self) -> Tuple[DataFile, ...]:
        files = self.table.current_files(self.snapshot_id)
        if self.scope == Scope.PARTITION and self.partition is not None:
            return tuple(f for f in files
                         if (f.partition or "") == self.partition)
        return files


def generate_candidates(tables, scope: Scope = Scope.TABLE,
                        hybrid: bool = False):
    """Candidate generation. ``hybrid``: partition scope for partitioned
    tables, table scope otherwise (the §6 'hybrid' strategy)."""
    out = []
    for t in tables:
        if hybrid:
            use = Scope.PARTITION if t.meta.partition_spec else Scope.TABLE
        else:
            use = scope
        if use == Scope.PARTITION and t.meta.partition_spec:
            for p in t.partitions():
                out.append(Candidate(t, Scope.PARTITION, partition=p))
        else:
            out.append(Candidate(t, Scope.TABLE))
    return out
