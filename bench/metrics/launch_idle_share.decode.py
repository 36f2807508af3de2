"""Share of the traced window in which the card is idle while the host is
inside a decode step's ``serve.step.launch`` span (building the step's
inputs and launching ``decode``): the card waiting on the host's
launches."""

import _spans


def read(rec):
    launch = _spans.named(_spans.window_spans(rec), "serve.step.launch")
    if not launch:
        return None
    return 100.0 * _spans.idle_within(rec, launch.values()) \
        / _spans.window_ns(rec)
