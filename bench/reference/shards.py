"""The plain reference of the corpus table's compaction.

A frozen copy of the token-shard format (``TOKS``, the true length as a
little-endian int64, the int32 tokens padded to 1024), the bin-pack plan
of Iceberg's ``rewriteDataFiles`` (first-fit decreasing of the files under
the target, bins of two files or more, in the order they were opened), the
GBHr of a rewrite (the paper's section 4.2: executor memory times the
bytes rewritten over the rewrite rate), and the replay that holds a run's
cycles to them. It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

MAGIC = b"TOKS"
CHUNK = 1024


def decode(raw: bytes) -> np.ndarray:
    if raw[:4] != MAGIC:
        raise ValueError("not a token shard")
    n = int.from_bytes(raw[4:12], "little", signed=True)
    return np.frombuffer(raw, dtype="<i4", count=n, offset=12)


def encoded_size(n_tokens: int) -> int:
    return 12 + 4 * (-(-n_tokens // CHUNK) * CHUNK)


def plan_bins(listing: Sequence[Tuple[str, int]], target: int,
              min_inputs: int = 2) -> List[List[str]]:
    """First-fit decreasing of the files under ``target`` bytes, ties in
    listing order; bins of fewer than ``min_inputs`` files are dropped."""
    small = sorted((f for f in listing if f[1] < target), key=lambda f: -f[1])
    bins: List[List[str]] = []
    fill: List[int] = []
    for path, size in small:
        for i, s in enumerate(fill):
            if s + size <= target:
                bins[i].append(path)
                fill[i] += size
                break
        else:
            bins.append([path])
            fill.append(size)
    return [b for b in bins if len(b) >= min_inputs]


def gbhr(rewritten_bytes: int, executor_memory_gb: float,
         rewrite_bytes_per_hour: float) -> float:
    return executor_memory_gb * (rewritten_bytes / rewrite_bytes_per_hour)


def replay(cycles: Sequence[Dict], tables: Sequence[Dict[str, List[int]]],
           pool: np.ndarray, target: int, executor_memory_gb: float,
           rewrite_bytes_per_hour: float) -> Dict[str, int]:
    """Holds each recorded cycle to the plan the reference makes from the
    listing it started from. ``tables[t]`` maps each committed file to
    its pool rows; each cycle holds ``table``, ``before`` (path, bytes in
    listing order), ``added`` (path -> (bytes, num_rows, size_bytes)),
    ``live_after`` and ``gbhr``. Counts the cycles whose removed or added
    files differ from the plan, the outputs whose tokens, rows or size
    differ from their inputs', and the cycles whose GBHr differs."""
    prov = [dict(t) for t in tables]
    rows = pool.shape[1]
    out = {"plan_mismatch": 0, "output_mismatch": 0, "gbhr_mismatch": 0}
    for c in cycles:
        pv = prov[c["table"]]
        paths = [p for p, _ in c["before"]]
        if any(p not in pv for p in paths):
            out["plan_mismatch"] += 1
            continue
        sizes = {p: encoded_size(len(pv[p]) * rows) for p in paths}
        bins = plan_bins([(p, sizes[p]) for p in paths], target)
        removed = set(paths) - set(c["live_after"])
        want_removed = {p for b in bins for p in b}
        if removed != want_removed or len(c["added"]) != len(bins):
            out["plan_mismatch"] += 1
        for k, b in enumerate(bins, 1):
            hit = [p for p in c["added"] if p.endswith(f"-{k}.toks")]
            if len(hit) != 1:
                out["plan_mismatch"] += 1
                continue
            raw, num_rows, size = c["added"][hit[0]]
            ids = [i for p in b for i in pv[p]]
            want = pool[ids].reshape(-1)
            got = decode(raw)
            if num_rows != want.size or size != len(raw) \
                    or size != encoded_size(want.size) \
                    or not np.array_equal(got, want):
                out["output_mismatch"] += 1
            pv[hit[0]] = ids
        for p in removed:
            pv.pop(p, None)
        want_gbhr = gbhr(sum(sizes[p] for p in want_removed),
                         executor_memory_gb, rewrite_bytes_per_hour)
        if abs(c["gbhr"] - want_gbhr) > 1e-9 * max(want_gbhr, 1e-300):
            out["gbhr_mismatch"] += 1
    return out
