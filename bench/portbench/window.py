"""The measured window's pacing: whole units of work (a ``generate`` call,
a cycle of requests, a table), each started only where it would still end
inside the window's seconds, so that a run never measures past
``--seconds``. A unit is taken to last as long as the longest so far; the
first always starts."""

from __future__ import annotations

import time


class Window:
    def __init__(self, seconds: float) -> None:
        self.seconds = float(seconds)
        self.t0 = time.perf_counter()
        self.end = self.t0
        self.longest = 0.0
        self.units = 0
        self.units_s = []     # each whole unit's seconds, in order

    def __iter__(self):
        while True:
            start = time.perf_counter()
            if self.units and start - self.t0 + self.longest > self.seconds:
                return
            yield self.units
            self.end = time.perf_counter()
            self.units_s.append(self.end - start)
            self.longest = max(self.longest, self.end - start)
            self.units += 1

    @property
    def elapsed(self) -> float:
        """From the window's start to the end of its last whole unit."""
        return self.end - self.t0
