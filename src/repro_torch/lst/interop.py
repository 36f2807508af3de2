"""Carry a table written elsewhere into this package's table layer.

The system has no weights: its state is table files. ``load_table`` takes
that state as plain data -- ``DataFile`` fields as dicts and the data
objects as ``{path: bytes}`` -- so a table written by another
implementation (for example the JAX package's writers) can be compacted
here and the results compared file by file.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

from repro_torch.lst.catalog import Catalog
from repro_torch.lst.files import DataFile
from repro_torch.lst.table import LogStructuredTable


def load_table(catalog: Catalog, namespace: str, table: str,
               files: Sequence[Mapping], objects: Mapping[str, bytes],
               partition_spec: Optional[str] = None,
               properties: Optional[Dict] = None) -> LogStructuredTable:
    """Create ``namespace/table`` and append ``files`` in ONE commit.

    files: one dict of ``DataFile`` fields per data file, in commit order
    objects: ``{path: bytes}`` holding at least every file's path
    """
    t = catalog.create_table(namespace, table, partition_spec, properties)
    data_files = [DataFile(**dict(f)) for f in files]
    for f in data_files:
        t.store.put(f.path, objects[f.path])
    t.append(data_files)
    return t
