"""Catalog + namespaces with object-count quotas — the OpenHouse stand-in.

A Namespace models the paper's "database": a logical group of tables owned
by a tenant, with an HDFS-namespace-object quota. AutoComp's production
weight adaptation (§7) reads ``quota_utilization`` from here:
    w1 = 0.5 * (1 + UsedQuota / TotalQuota).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, List, Optional

from repro_torch.lst.storage import ObjectStore
from repro_torch.lst.table import LogStructuredTable


@dataclasses.dataclass
class Namespace:
    name: str
    total_quota: int                    # max namespace objects (files)
    tables: Dict[str, LogStructuredTable] = dataclasses.field(default_factory=dict)

    def used_quota(self) -> int:
        return sum(t.file_count() for t in self.tables.values())

    def quota_utilization(self) -> float:
        if self.total_quota <= 0:
            return 0.0
        return min(1.0, self.used_quota() / self.total_quota)


class Catalog:
    def __init__(self, store: ObjectStore, now_fn=None) -> None:
        self.store = store
        self.namespaces: Dict[str, Namespace] = {}
        self._lock = threading.RLock()
        self._write_listeners: List = []
        self.now_fn = now_fn

    def create_namespace(self, name: str, total_quota: int = 1_000_000
                         ) -> Namespace:
        with self._lock:
            ns = self.namespaces.get(name)
            if ns is None:
                ns = Namespace(name, total_quota)
                self.namespaces[name] = ns
            return ns

    def create_table(self, namespace: str, table: str,
                     partition_spec: Optional[str] = None,
                     properties: Optional[Dict] = None) -> LogStructuredTable:
        with self._lock:
            ns = self.create_namespace(namespace)
            tid = f"{namespace}/{table}"
            kwargs = {}
            if self.now_fn is not None:
                kwargs["now_fn"] = self.now_fn
            t = LogStructuredTable(self.store, tid, partition_spec,
                                   properties, **kwargs)
            ns.tables[table] = t
            return t

    def get_table(self, namespace: str, table: str) -> LogStructuredTable:
        return self.namespaces[namespace].tables[table]

    def tables(self) -> List[LogStructuredTable]:
        with self._lock:
            return [t for ns in self.namespaces.values()
                    for t in ns.tables.values()]

    def namespace_of(self, table: LogStructuredTable) -> Namespace:
        ns_name = table.table_id.split("/", 1)[0]
        return self.namespaces[ns_name]

    # --- optimize-after-write hook plumbing (§5 "push" mode) ---------------
    def add_write_listener(self, fn) -> None:
        self._write_listeners.append(fn)

    def notify_write(self, table: LogStructuredTable) -> None:
        for fn in self._write_listeners:
            fn(table)
