"""Seconds of the window's AutoComp cycles spent outside the merges:
the harness's span around each ``run_cycle`` (observe, orient, decide,
the plan and the commits) less every stage of ``STAGE_SECONDS``."""


def read(rec):
    st = rec.info.get("stage_seconds")
    if st is None or "cycle" not in rec.spans:
        return None
    return rec.seconds("cycle") - sum(st.values())
