"""Share of the snapshot entries in the table layer's metadata files that
were reused rather than encoded anew: 100 x (1 - the program's counter
``lst.meta.snapshots_encoded`` over ``lst.meta.snapshots_written``, both
from ``lst/files.py::TableMetadata.serialize``). A program that records
neither counter gives None."""

import _spans


def read(rec):
    c = _spans.program_counters()
    written = (c or {}).get("lst.meta.snapshots_written", 0)
    if not written:
        return None
    return 100.0 * (1.0 - c.get("lst.meta.snapshots_encoded", 0) / written)
