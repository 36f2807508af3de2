"""Seconds of the window's AutoComp cycles outside the merges, from the
program's own spans: every ``autocomp.cycle`` (observe, orient, decide,
act and its commits) less each ``act.merge`` under a cycle. The inside
twin of ``outside_merge_s.compact``."""

import _spans


def read(rec):
    sp = _spans.window_spans(rec)
    cycles = _spans.named(sp, "autocomp.cycle")
    if not cycles:
        return None
    merges = [s for s in _spans.named(sp, "act.merge").values()
              if _spans.has_ancestor(sp, s, "autocomp.cycle")]
    return (sum(map(_spans.length, cycles.values()))
            - sum(map(_spans.length, merges))) * 1e-9
