"""The merges' share of the memory roofline: the bytes they must move
(each input shard's bytes read once, each output's written once, from the
files the cycles replaced and wrote) at the card's HBM bandwidth, over
the device time of every kernel (copies left out) that ran inside the
harness's spans around the cycles. It reads the same work whatever
kernel does it."""

import _work


def read(rec):
    if rec.trace is None or not rec.counters.get("merge_bytes"):
        return None
    t = rec.trace.op_seconds_within("cycle", kinds=("kernel",))
    if t <= 0:
        return None
    return 100.0 * rec.counters["merge_bytes"] / _work.HBM_BYTES_PER_S / t
