"""The allocator's peak of the run (``torch.cuda.max_memory_allocated``
after a reset at set-up): weights, the slot table's cache and the decode
step's transients."""


def read(rec):
    peak = rec.counters.get("memory_peak_bytes", 0)
    return peak / 2 ** 30 if peak else None
