"""Mean length of the table layer's commit, the program's ``lst.commit``
span (``lst/table.py::_try_commit``: rebase, manifest, metadata), over
the window's commits: the writer's flushes and the cycles' rewrites."""

import statistics

import _spans


def read(rec):
    commits = _spans.named(_spans.window_spans(rec), "lst.commit")
    if not commits:
        return None
    return statistics.fmean(map(_spans.length, commits.values())) * 1e-6
