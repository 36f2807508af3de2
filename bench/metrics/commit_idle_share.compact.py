"""Share of the traced window in which the card is idle while the host is
inside the table layer's ``lst.commit`` span."""

import _spans


def read(rec):
    commits = _spans.named(_spans.window_spans(rec), "lst.commit")
    if not commits:
        return None
    return 100.0 * _spans.idle_within(rec, commits.values()) \
        / _spans.window_ns(rec)
