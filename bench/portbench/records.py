"""What a run records for its metrics: host-clock spans that the harness
takes around its calls into the program, counters it reads from the
program, and, in a traced run, the profiler's device trace of the window.

Spans are kept in memory, on the host's clock and, for the trace, on the
profiler's (nanoseconds since the epoch), so the trace can say what the
host was doing in a gap. The profiler records the card's activity only:
recording every host op as well would cost more than the window.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional, Tuple

DEVICE_OP = ("kernel", "memcpy", "memset")


class Records:
    def __init__(self, tracing: bool = False) -> None:
        self.tracing = tracing
        self.counters: Dict[str, float] = {}
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        self.info: Dict[str, Any] = {}   # facts a reader needs (sizes)
        self.trace: Optional["Trace"] = None
        self.window: Tuple[float, float] = (0.0, 0.0)
        self.notes: List[Tuple[str, int, int]] = []   # spans, epoch ns

    @contextlib.contextmanager
    def span(self, name: str):
        t0, n0 = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append((t0, time.perf_counter()))
            if self.tracing:
                self.notes.append((name, n0, time.time_ns()))

    def add(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def seconds(self, name: str) -> float:
        """Summed length of the spans of one name."""
        return sum(b - a for a, b in self.spans.get(name, ()))

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


class Trace:
    """The device trace of the window from ``torch.profiler``: device
    operations (kernels, copies, sets) and the harness's annotations, in
    the profiler's nanoseconds."""

    def __init__(self, ops, annotations, window) -> None:
        self.ops: List[Tuple[str, str, int, int]] = ops    # kind,name,t0,t1
        self.annotations: List[Tuple[str, int, int]] = annotations
        self.window: Tuple[int, int] = window

    @classmethod
    def from_profiler(cls, prof, rec: Records) -> "Trace":
        """The card's operations from the profiler's events: copies and
        sets by their names, every other device event a kernel."""
        from torch.autograd import DeviceType

        ops = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            name = e.name()
            kind = "memcpy" if name.startswith("Memcpy") else \
                "memset" if name.startswith("Memset") else "kernel"
            t0 = e.start_ns() if hasattr(e, "start_ns") else \
                int(e.start_us() * 1000)
            dur = e.duration_ns() if hasattr(e, "duration_ns") else \
                int(e.duration_us() * 1000)
            ops.append((kind, name, t0, t0 + dur))
        wins = [(a, b) for n, a, b in rec.notes if n == "window"]
        return cls(ops, rec.notes, wins[-1])

    def busy_intervals(self, kinds=DEVICE_OP) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        window."""
        lo, hi = self.window
        iv = sorted((max(a, lo), min(b, hi)) for k, _, a, b in self.ops
                    if k in kinds and b > lo and a < hi)
        out: List[List[int]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def op_seconds_within(self, span_name: str, kinds=("kernel",)) -> float:
        """Device time of the operations of ``kinds`` that ran inside the
        harness spans named ``span_name`` (each span ends in a wait for
        the device, so its operations lie inside it)."""
        spans = sorted((a, b) for n, a, b in self.annotations
                       if n == span_name)
        if not spans:
            return 0.0
        import bisect
        starts = [a for a, _ in spans]
        total = 0
        for k, _, a, b in self.ops:
            if k not in kinds:
                continue
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and b <= spans[i][1]:
                total += b - a
        return total * 1e-9

    def breakdown(self, span_names, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time in the window, and
        the longest idle gaps named by the innermost harness span that
        covers each gap's middle ("host" where none does)."""
        lo, hi = self.window
        by_name: Dict[str, int] = {}
        for _, name, a, b in self.ops:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                by_name[name] = by_name.get(name, 0) + (b - a)
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = [], lo
        for a, b in self.busy_intervals() + [(hi, hi)]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        names = set(span_names) - {"window"}
        notes = [(n, a, b) for n, a, b in self.annotations if n in names]
        out = []
        for a, b in gaps[:top]:
            mid = (a + b) // 2
            cover = [(bb - aa, n) for n, aa, bb in notes if aa <= mid <= bb]
            out.append([min(cover)[1] if cover else "host", (b - a) * 1e-9])
        return {"device_ops": [[n, t * 1e-9] for n, t in device_ops],
                "idle_gaps": out}
