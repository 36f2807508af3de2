"""Observe phase (§3.3/§4.1): extract statistics for each candidate.

The standardized stats layout supports generic metrics (file counts/sizes)
plus platform-specific custom metrics injected through ``custom_fns`` —
e.g. access frequency from the data-pipeline reader, or checkpoint age from
the training runner.

Fleet-scale note: the generic statistics of a candidate are a pure function
of its snapshot, so the collector memoizes them per (table, scope,
partition, snapshot). A 2k-table fleet cycle re-scans only the tables whose
snapshot actually moved since the last cycle; everything else is a dict
hit. Activity-derived metrics (query frequency, write rates from
``lst.workload.ActivityTracker``) move *without* a new snapshot, so they
are re-evaluated on every observe and never cached.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.model import Candidate, CandidateStats

BUCKETS = 16  # power-of-two size buckets starting at 1 MiB


def size_bucket(size_bytes: int) -> int:
    mb = max(size_bytes / (1 << 20), 1e-6)
    b = int(math.floor(math.log2(mb))) + 1 if mb >= 1 else 0
    return min(max(b, 0), BUCKETS - 1)


class StatsCollector:
    def __init__(self, target_file_bytes: int,
                 custom_fns: Optional[Dict[str, Callable]] = None,
                 activity=None) -> None:
        self.target = target_file_bytes
        self.custom_fns = custom_fns or {}
        # activity: lst.workload.ActivityTracker (or anything with
        # read_rate/write_file_rate/burstiness) feeding query-frequency
        # stats into the candidate pool
        self.activity = activity
        # (table_id, scope, partition) -> (snapshot_id, stats sans custom);
        # one slot per candidate identity, so memory is bounded by the
        # candidate pool, not by history
        self._memo: Dict[Tuple[str, str, str],
                         Tuple[Optional[int], CandidateStats]] = {}
        self.memo_hits = 0
        self.memo_misses = 0

    def _scan(self, cand: Candidate) -> CandidateStats:
        files = cand.files()
        hist = [0] * BUCKETS
        small = 0
        small_bytes = 0
        total = 0
        for f in files:
            hist[size_bucket(f.size_bytes)] += 1
            total += f.size_bytes
            if f.size_bytes < self.target:
                small += 1
                small_bytes += f.size_bytes
        return CandidateStats(
            file_count=len(files),
            total_bytes=total,
            small_file_count=small,
            small_bytes=small_bytes,
            size_histogram=tuple(hist),
            partition_count=len({f.partition for f in files}),
            created_at=cand.table.meta.created_at,
            last_write_at=cand.table.meta.last_write_at,
        )

    def observe(self, cand: Candidate) -> CandidateStats:
        key = (cand.table.table_id, cand.scope.value, cand.partition or "")
        sid = cand.snapshot_id if cand.snapshot_id is not None \
            else cand.table.meta.current_snapshot_id
        hit = self._memo.get(key)
        if hit is not None and hit[0] == sid:
            self.memo_hits += 1
            stats = dataclasses.replace(hit[1], custom={})
        else:
            self.memo_misses += 1
            stats = self._scan(cand)
            self._memo[key] = (sid, dataclasses.replace(stats, custom={}))
        if self.activity is not None:
            tid = cand.table.table_id
            stats.custom["query_freq"] = self.activity.read_rate(tid)
            stats.custom["write_rate"] = self.activity.write_rate(tid)
            stats.custom["write_file_rate"] = \
                self.activity.write_file_rate(tid)
            stats.custom["burstiness"] = self.activity.burstiness(tid)
        for name, fn in self.custom_fns.items():
            stats.custom[name] = fn(cand)
        cand.stats = stats
        return stats

    def observe_all(self, cands: Iterable[Candidate]) -> List[Candidate]:
        out = []
        for c in cands:
            self.observe(c)
            out.append(c)
        return out
