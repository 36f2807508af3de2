"""Median over requests of the program's ``serve.queue`` span: from the
``generate`` call's start to the request's admission into a slot, its
first token on the host (the prefills of the requests ahead of it and its
own)."""

import statistics

import _spans


def read(rec):
    queue = _spans.named(_spans.window_spans(rec), "serve.queue")
    if not queue:
        return None
    return statistics.median(map(_spans.length, queue.values())) * 1e-6
