"""The program's own spans (``repro_torch.obs``) as the metrics read them:
those of the traced window, clipped to it; a span's self time (its length
less the part its children cover); and the card's idle time inside a set
of spans (from the trace's busy intervals). Stamps are the profiler's
nanoseconds since the epoch. A program that records no spans (one
without ``repro_torch.obs``) gives None, and so does an untraced run."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple


def window_spans(rec) -> Optional[Dict[int, tuple]]:
    """{index: span} of the program's closed spans that overlap the traced
    window, each clipped to it; parents keep their indices."""
    if rec.trace is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    lo, hi = rec.trace.window
    return {i: s._replace(start=max(s.start, lo), end=min(s.end, hi))
            for i, s in enumerate(obs.spans())
            if s.end is not None and s.end > lo and s.start < hi}


def program_counters() -> Optional[Dict[str, float]]:
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.counters()


def named(spans, name: str) -> Dict[int, tuple]:
    return {i: s for i, s in (spans or {}).items() if s.name == name}


def length(s) -> int:
    return s.end - s.start


def children(spans, i: int, name: Optional[str] = None) -> List[tuple]:
    return [s for s in spans.values() if s.parent == i
            and (name is None or s.name == name)]


def has_ancestor(spans, s, name: str) -> bool:
    while s.parent in spans:
        s = spans[s.parent]
        if s.name == name:
            return True
    return False


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(xs: List[Tuple[int, int]], ys: List[Tuple[int, int]]) -> int:
    """Length shared by two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def self_time(spans, i: int) -> int:
    s = spans[i]
    kids = union((max(c.start, s.start), min(c.end, s.end))
                 for c in children(spans, i))
    return length(s) - sum(b - a for a, b in kids)


def idle_within(rec, spans) -> int:
    """Nanoseconds inside the union of ``spans`` with the card idle."""
    iv = union((s.start, s.end) for s in spans)
    return sum(b - a for a, b in iv) - overlap(iv, rec.trace.busy_intervals())


def window_ns(rec) -> int:
    lo, hi = rec.trace.window
    return hi - lo
