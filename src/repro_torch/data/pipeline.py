"""Host data pipeline: scan-plan the shard table, read + pack token shards,
and hand each batch over as tensors on the device, prefetched on a
background thread.

Step-time here is the framework-level analogue of the paper's query latency
(Figs. 3/8): planning cost scales with file count (metadata + open() RPCs),
so AutoComp compaction of the shard table directly improves data-loading
latency.

Batches are ``{"tokens", "labels"}`` int32 tensors of shape
``(batch, seq_len)`` on ``device``: the CUDA card by default, or ``"cpu"``.
There is no silent fallback: with no CUDA device the default raises. On the
card each batch is staged in pinned host memory and copied on the
pipeline's own CUDA stream; the copy has finished before the batch is
handed over, and the batch's memory is marked as used on the consumer's
stream, so a consumer never reads a batch whose copy is still in flight.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, List, Union

import numpy as np
import torch

from repro_torch.data import shards as sh
from repro_torch.data.packing import pack_tokens
from repro_torch.lst.table import LogStructuredTable


class DataPipeline:
    def __init__(self, table: LogStructuredTable, batch: int, seq_len: int,
                 prefetch: int = 2, seed: int = 0,
                 device: Union[str, torch.device] = "cuda") -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DataPipeline: no CUDA device; pass "
                               "device='cpu' for host tensors")
        self.table = table
        self.batch = batch
        self.seq_len = seq_len
        self.prefetch = prefetch
        self.seed = seed
        self.plan_time_s = 0.0
        self.read_time_s = 0.0
        # host time to stage each batch in (pinned) memory and copy it to
        # the device, the copy's completion included
        self.h2d_time_s = 0.0
        self.files_scanned = 0
        self._copy_stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None

    # ---------------------------------------------------------------- plan
    def plan(self) -> List:
        t0 = time.perf_counter()
        files = [f for f in self.table.scan() if f.path.endswith(".toks")]
        files.sort(key=lambda f: f.path)
        self.plan_time_s = time.perf_counter() - t0
        self.files_scanned = len(files)
        return files

    # ---------------------------------------------------------------- read
    def _read_stream(self) -> np.ndarray:
        files = self.plan()
        t0 = time.perf_counter()
        parts = [sh.decode_shard(self.table.store.get(f.path)) for f in files]
        self.read_time_s = time.perf_counter() - t0
        if not parts:
            return np.zeros(0, np.int32)
        return np.concatenate(parts)

    def _slabs(self) -> Iterator[np.ndarray]:
        """The packed (batch, seq_len + 1) slabs in the seeded order."""
        stream = self._read_stream()
        slabs = pack_tokens(stream, self.batch, self.seq_len)
        rng = np.random.RandomState(self.seed)
        order = rng.permutation(len(slabs))
        for i in order:
            yield slabs[i]

    def _to_device(self, slab: np.ndarray) -> Dict[str, torch.Tensor]:
        """Tokens and labels of one slab in one (pinned) host buffer, then
        one copy to the device, waited for."""
        t0 = time.perf_counter()
        cuda = self.device.type == "cuda"
        host = torch.empty((2, self.batch, self.seq_len), dtype=torch.int32,
                           pin_memory=cuda)
        view = host.numpy()
        view[0] = slab[:, :-1]
        view[1] = slab[:, 1:]
        if cuda:
            with torch.cuda.stream(self._copy_stream):
                out = host.to(self.device, non_blocking=True)
            self._copy_stream.synchronize()
        else:
            out = host
        self.h2d_time_s += time.perf_counter() - t0
        return {"tokens": out[0], "labels": out[1]}

    def _hand_over(self, b: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """The batch was made on the copy stream; the consumer reads it on
        its current stream, which the caching allocator must know before
        it reuses the memory."""
        if self.device.type == "cuda":
            consumer = torch.cuda.current_stream(self.device)
            for t in b.values():
                t.record_stream(consumer)
        return b

    def batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        for slab in self._slabs():
            yield self._hand_over(self._to_device(slab))

    def prefetching_batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        """Background-thread prefetch: reading, packing and the copies to
        the device overlap the consumer's step. An error in the thread is
        raised to the consumer; a consumer that stops early stops the
        thread."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        done = threading.Event()

        def worker():
            try:
                for slab in self._slabs():
                    if done.is_set():
                        return
                    q.put(self._to_device(slab))
            except Exception as e:      # handed to the consumer, re-raised
                q.put(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, Exception):
                    raise item
                yield self._hand_over(item)
        finally:
            done.set()
            while t.is_alive():        # unblock a worker waiting on put
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()

    # ------------------------------------------------------------- metrics
    def stats(self) -> Dict[str, float]:
        return {"plan_time_s": self.plan_time_s,
                "read_time_s": self.read_time_s,
                "files_scanned": float(self.files_scanned)}
