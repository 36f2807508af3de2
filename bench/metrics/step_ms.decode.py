"""Median length of the slot engine's decode step: the program's
``serve.step`` span (``launch/serve.py::_generate_slots``), from the
step's inputs to the slot table's bookkeeping after its tokens reach the
host."""

import statistics

import _spans


def read(rec):
    steps = _spans.named(_spans.window_spans(rec), "serve.step")
    if not steps:
        return None
    return statistics.median(map(_spans.length, steps.values())) * 1e-6
