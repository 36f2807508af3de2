"""Spans and counters inside the port, on the profiler's clock.

A span is ``(name, start, end, parent, req)``: stamps in nanoseconds
since the epoch (``time.time_ns``, the clock ``torch.profiler``'s events
are on), ``parent`` the index in :func:`spans` of the span that was open
on the same thread when it began (-1 for none), and ``req`` the request
it served, where it served one. A counter is a named sum.

Recording is on while an operator has called :func:`enable`, or while a
``torch.profiler`` session records on the calling thread, so a traced
run gets the program's spans with no further switch. When off, a span
site costs one check and returns a shared no-op context, and a counter
site one check: no tensor work and no sync either way. The buffer holds
at most ``MAX_SPANS`` spans; later ones are not kept until
:func:`clear`. Nothing is written anywhere: a reader calls
:func:`spans` and :func:`counters`.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch

MAX_SPANS = 1 << 20

Span = collections.namedtuple("Span", "name start end parent req")

now = time.time_ns

_enabled = False
# [name, start, end, parent's record or None, req]; a list append is
# atomic under the interpreter lock, so spans take no lock of their own
_spans: List[list] = []
_counters: Dict[str, float] = {}
_lock = threading.Lock()     # the counters' read-modify-write
_local = threading.local()   # .open: this thread's open spans, innermost last


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    """Stop recording (a running profiler session still records)."""
    global _enabled
    _enabled = False


def on() -> bool:
    return _enabled or torch.autograd._profiler_enabled()


def _open() -> list:
    try:
        return _local.open
    except AttributeError:
        _local.open = []
        return _local.open


def _add(name, start, stop, parent, req):
    if len(_spans) >= MAX_SPANS:
        return None
    rec = [name, start, stop, parent, req]
    _spans.append(rec)
    return rec


def begin(name: str, req=None, start: Optional[int] = None):
    """Open a span (``start`` defaults to now) under this thread's
    innermost open span; returns the handle :func:`end` takes, or None
    when recording is off or the buffer is full."""
    if not on():
        return None
    return _begin(name, req, now() if start is None else start)


def _begin(name, req, start):
    stack = _open()
    rec = _add(name, start, None, stack[-1] if stack else None, req)
    if rec is not None:
        stack.append(rec)
    return rec


def end(rec, stop: Optional[int] = None) -> None:
    """Close ``rec`` (``stop`` defaults to now), and any span opened
    inside it that an exception left open."""
    if rec is None:
        return
    rec[2] = now() if stop is None else stop
    stack = _open()
    if stack and stack[-1] is rec:
        stack.pop()
    elif any(r is rec for r in stack):
        while stack.pop() is not rec:
            pass


def record(name: str, start: int, stop: int, parent=None, req=None):
    """A span from stamps the caller took (from :func:`now`); its parent
    is ``parent`` (a handle) or else this thread's innermost open span.
    Returns its handle, for children recorded the same way."""
    if not on():
        return None
    if parent is None:
        stack = _open()
        parent = stack[-1] if stack else None
    return _add(name, start, stop, parent, req)


class _Span:
    __slots__ = ("name", "req", "rec")

    def __init__(self, name, req):
        self.name, self.req = name, req

    def __enter__(self):
        self.rec = _begin(self.name, self.req, now())
        return self.rec

    def __exit__(self, *exc):
        end(self.rec)
        return False


_NOOP = contextlib.nullcontext()


def span(name: str, req=None):
    """``with span(name):`` records the block as a span; the ``as``
    target is its handle (None when off)."""
    return _Span(name, req) if on() else _NOOP


def count(name: str, n: float = 1) -> None:
    if on():
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def spans() -> List[Span]:
    """Every span since the last :func:`clear`, in the order they began;
    ``end`` is None for one still open, ``parent`` -1 for none (or one
    cleared away)."""
    recs = list(_spans)
    pos = {id(r): i for i, r in enumerate(recs)}
    return [Span(n, a, b, -1 if p is None else pos.get(id(p), -1), q)
            for n, a, b, p, q in recs]


def counters() -> Dict[str, float]:
    with _lock:
        return dict(_counters)


def clear() -> None:
    with _lock:
        _spans.clear()
        _counters.clear()
