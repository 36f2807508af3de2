"""Metered object stores — the HDFS/ADLS stand-in.

All reads/writes of data files AND metadata go through an ObjectStore, which
meters the NameNode-pressure observables from §2/§7 of the paper: object
count, open()/create()/delete() RPCs, bytes moved. Benchmarks read these
counters to reproduce Fig. 10c (file count over time) and Fig. 11b (open()
calls).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Iterable, List, Optional


class StoreMetrics:
    def __init__(self) -> None:
        self.open_calls = 0
        self.create_calls = 0
        self.delete_calls = 0
        self.list_calls = 0
        self.bytes_read = 0
        self.bytes_written = 0

    @property
    def rpc_total(self) -> int:
        return (self.open_calls + self.create_calls + self.delete_calls
                + self.list_calls)

    def snapshot(self) -> Dict[str, int]:
        return {k: getattr(self, k) for k in
                ("open_calls", "create_calls", "delete_calls", "list_calls",
                 "bytes_read", "bytes_written")} | {"rpc_total": self.rpc_total}


class ObjectStore:
    """Abstract metered object store."""

    def __init__(self) -> None:
        self.metrics = StoreMetrics()
        self._lock = threading.RLock()

    # -- interface -----------------------------------------------------------
    def put(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, path: str) -> bytes:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    @property
    def object_count(self) -> int:
        raise NotImplementedError

    def count(self, prefix: str) -> int:
        return len([p for p in self.list(prefix)])


class InMemoryStore(ObjectStore):
    def __init__(self) -> None:
        super().__init__()
        self._objects: Dict[str, bytes] = {}

    def put(self, path: str, data: bytes) -> None:
        with self._lock:
            self.metrics.create_calls += 1
            self.metrics.bytes_written += len(data)
            self._objects[path] = bytes(data)

    def get(self, path: str) -> bytes:
        with self._lock:
            self.metrics.open_calls += 1
            if path not in self._objects:
                raise FileNotFoundError(path)
            data = self._objects[path]
            self.metrics.bytes_read += len(data)
            return data

    def delete(self, path: str) -> None:
        with self._lock:
            self.metrics.delete_calls += 1
            self._objects.pop(path, None)

    def exists(self, path: str) -> bool:
        with self._lock:
            return path in self._objects

    def list(self, prefix: str = "") -> List[str]:
        with self._lock:
            self.metrics.list_calls += 1
            return sorted(p for p in self._objects if p.startswith(prefix))

    @property
    def object_count(self) -> int:
        return len(self._objects)

    def size_of(self, path: str) -> int:
        return len(self._objects[path])


class LocalFSStore(ObjectStore):
    """On-disk store (used by the end-to-end training example)."""

    def __init__(self, root: str) -> None:
        super().__init__()
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._index: set = set()
        for dirpath, _, files in os.walk(root):
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), root)
                self._index.add(rel)

    def _abs(self, path: str) -> str:
        return os.path.join(self.root, path)

    def put(self, path: str, data: bytes) -> None:
        with self._lock:
            self.metrics.create_calls += 1
            self.metrics.bytes_written += len(data)
            ap = self._abs(path)
            os.makedirs(os.path.dirname(ap), exist_ok=True)
            tmp = ap + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, ap)          # atomic publish
            self._index.add(path)

    def get(self, path: str) -> bytes:
        with self._lock:
            self.metrics.open_calls += 1
            try:
                with open(self._abs(path), "rb") as f:
                    data = f.read()
            except OSError as e:
                raise FileNotFoundError(path) from e
            self.metrics.bytes_read += len(data)
            return data

    def delete(self, path: str) -> None:
        with self._lock:
            self.metrics.delete_calls += 1
            try:
                os.remove(self._abs(path))
            except OSError:
                pass
            self._index.discard(path)

    def exists(self, path: str) -> bool:
        return path in self._index or os.path.exists(self._abs(path))

    def list(self, prefix: str = "") -> List[str]:
        with self._lock:
            self.metrics.list_calls += 1
            return sorted(p for p in self._index if p.startswith(prefix))

    @property
    def object_count(self) -> int:
        return len(self._index)
