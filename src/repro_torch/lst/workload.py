"""Logical clock for the table layer.

Only ``SimClock`` is carried over so far; the CAB-like workload simulator
of the JAX package's ``lst/workload.py`` is still to port.
"""

from __future__ import annotations


class SimClock:
    """Logical time in hours (float)."""

    def __init__(self, start: float = 0.0) -> None:
        self.t = start

    def now(self) -> float:
        return self.t

    def advance(self, hours: float) -> None:
        self.t += hours
