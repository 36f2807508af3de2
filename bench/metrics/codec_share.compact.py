"""Share of the window that the merges' host codec takes: the program's
``data.packing.STAGE_SECONDS`` decode (store reads, decode, planning) and
encode (re-encode and store write), over the window."""


def read(rec):
    st = rec.info.get("stage_seconds")
    if not st or rec.window_s <= 0:
        return None
    return 100.0 * (st["decode"] + st["encode"]) / rec.window_s
