"""Orient phase (§4.2): turn statistics into *traits* — decision helpers
describing either the benefit of compacting a candidate (file-count
reduction, file entropy) or its cost (compute GBHr).

Traits are defined independently of one another and combined only at
ranking time, exactly as the paper prescribes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Protocol

from repro_torch.core.model import Candidate


@dataclasses.dataclass
class TraitContext:
    target_file_bytes: int
    executor_memory_gb: float = 8.0
    rewrite_bytes_per_hour: float = 256e9   # calibrated from the packer bench


class Trait(Protocol):
    name: str
    kind: str                                # "benefit" | "cost"

    def compute(self, cand: Candidate, ctx: TraitContext) -> float: ...


class FileCountReductionTrait:
    """Paper §4.2: ΔF_c = Σ_i 1(FileSize_i < TargetFileSize).

    ``partition_aware=True`` applies the §7 refinement: compaction does not
    cross partition boundaries, so the achievable reduction is
    Σ_partitions (small_p - ceil(small_bytes_p / target)).
    """
    name = "file_count_reduction"
    kind = "benefit"

    def __init__(self, partition_aware: bool = False):
        self.partition_aware = partition_aware

    def compute(self, cand: Candidate, ctx: TraitContext) -> float:
        if not self.partition_aware:
            return float(cand.stats.small_file_count)
        per_part: Dict[str, List[int]] = {}
        for f in cand.files():
            if f.size_bytes < ctx.target_file_bytes:
                per_part.setdefault(f.partition or "", []).append(f.size_bytes)
        red = 0.0
        for sizes in per_part.values():
            out_files = math.ceil(sum(sizes) / ctx.target_file_bytes) or 1
            red += max(0, len(sizes) - out_files)
        return red


class FileEntropyTrait:
    """File entropy (Netflix auto-optimize [65]): Shannon entropy of the
    file-size distribution. A table fully packed at the target size has
    entropy ~log(N) with uniform p_i; heavy fragmentation (many small files)
    raises entropy *relative to the ideal packing of the same bytes*. We
    report  H_actual - H_ideal  (>= 0, higher = more fragmented):
        H = -Σ (s_i/S) ln (s_i/S)
        H_ideal computed for ceil(S/target) equal files.
    """
    name = "file_entropy"
    kind = "benefit"

    def compute(self, cand: Candidate, ctx: TraitContext) -> float:
        files = cand.files()
        total = sum(f.size_bytes for f in files)
        if total <= 0 or not files:
            return 0.0
        h = 0.0
        for f in files:
            p = max(f.size_bytes, 1) / total
            h -= p * math.log(p)
        n_ideal = max(1, math.ceil(total / ctx.target_file_bytes))
        h_ideal = math.log(n_ideal)
        return max(0.0, h - h_ideal)


class ComputeCostTrait:
    """Paper §4.2: GBHr_c = ExecutorMemoryGB * DataSize_c / RewriteBytesPerHour
    where DataSize_c counts the bytes that must actually be rewritten (small
    files only)."""
    name = "compute_cost"
    kind = "cost"

    def __init__(self, small_files_only: bool = True):
        self.small_files_only = small_files_only

    def compute(self, cand: Candidate, ctx: TraitContext) -> float:
        data = cand.stats.small_bytes if self.small_files_only \
            else cand.stats.total_bytes
        return ctx.executor_memory_gb * (data / ctx.rewrite_bytes_per_hour)


DEFAULT_TRAITS = (FileCountReductionTrait(), FileEntropyTrait(),
                  ComputeCostTrait())


def compute_traits(cands: Iterable[Candidate], traits, ctx: TraitContext
                   ) -> List[Candidate]:
    out = []
    for c in cands:
        for t in traits:
            c.traits[t.name] = float(t.compute(c, ctx))
        out.append(c)
    return out
