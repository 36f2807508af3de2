"""Optional filters between OODA phases (§3.3/§4.1): refine the candidate
pool using statistics and table usage. Platform-specific policies (recently
created tables, write-conflict risk, trivial tables) are expressed here.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

from repro_torch.core.model import Candidate


class MinAgeFilter:
    """OpenHouse policy: don't compact tables created within a window —
    avoids spending budget on tables that won't affect long-term health."""

    def __init__(self, min_age_hours: float, now_fn: Callable[[], float]):
        self.min_age = min_age_hours
        self.now_fn = now_fn

    def __call__(self, c: Candidate) -> bool:
        return (self.now_fn() - c.stats.created_at) >= self.min_age


class RecentWriteFilter:
    """Skip candidates with very recent writes (conflict risk, §4.4)."""

    def __init__(self, quiet_hours: float, now_fn: Callable[[], float]):
        self.quiet = quiet_hours
        self.now_fn = now_fn

    def __call__(self, c: Candidate) -> bool:
        return (self.now_fn() - c.stats.last_write_at) >= self.quiet


class MinSmallFilesFilter:
    """Compaction is pointless below a handful of small files."""

    def __init__(self, min_small_files: int = 2):
        self.min_small = min_small_files

    def __call__(self, c: Candidate) -> bool:
        return c.stats.small_file_count >= self.min_small


class MaxCostFilter:
    """Discard candidates whose estimated cost exceeds a hard cap (§4.2:
    'candidates with a compute cost that exceeds the allocated budget can be
    automatically discarded')."""

    def __init__(self, max_gbhr: float):
        self.max_gbhr = max_gbhr

    def __call__(self, c: Candidate) -> bool:
        return c.traits.get("compute_cost", 0.0) <= self.max_gbhr


def apply_filters(cands: Iterable[Candidate], filters) -> List[Candidate]:
    out = []
    for c in cands:
        if all(f(c) for f in filters):
            out.append(c)
    return out
