"""Median over decode steps of the host's own time in a step: the
``serve.step`` span less its ``serve.step.wait`` child (the token's pick
and its copy to the host, where the host waits for the card). What is
left is the step's launches and the slot table's bookkeeping."""

import statistics

import _spans


def read(rec):
    sp = _spans.window_spans(rec)
    steps = _spans.named(sp, "serve.step")
    if not steps:
        return None
    return statistics.median(
        _spans.length(s) - sum(map(_spans.length, _spans.children(
            sp, i, "serve.step.wait")))
        for i, s in steps.items()) * 1e-6
