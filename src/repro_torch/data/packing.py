"""Sequence packing + the compaction merge_fn for token shards.

``merge_shards_fn`` is what AutoComp's Act phase calls when the candidate is
a token-shard table: it concatenates the chunk-aligned payloads of the input
shards, moves them to the device, and runs the compact_pack CUDA kernel to
produce the merged shard.

With ``filter_fn`` it becomes a rewrite-delete: deletes applied AT
compaction time, in the same pass, via the fused filter+pack kernel
(``compact_chunks(..., keep_mask=)``) -- dropped rows are never read.
``fused_filter=False`` routes the identical mask through the two-pass
filter-then-pack plain version instead; the outputs are bit-identical,
only the device traffic differs.

``STAGE_SECONDS`` accumulates the host-clock time of each stage of every
merge: store reads, decode, planning and a delete's row predicate
(``decode``), the copy to the device (``h2d``), the op's own host planning
up to the kernel launch (``plan``), the kernel (``kernel``), the copy back
(``d2h``) and the re-encode and store write (``encode``). On a CUDA device the merge
synchronises after the upload and after the op, where the next stage would
wait anyway, so the split costs nothing. The same clock readings give
the merge's spans (:mod:`repro_torch.obs`, when on): ``act.merge`` with
a child ``merge.<stage>`` for each stage.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.data import shards as sh
from repro_torch.kernels.compact_pack import compact_chunks, plan_compaction
from repro_torch.kernels.compact_pack.compact_pack import (
    CHUNK_COLS, CHUNK_ROWS, CHUNK_TOKENS)
from repro_torch.lst.compaction import CompactionTask
from repro_torch.lst.files import DataFile
from repro_torch.lst.table import LogStructuredTable

STAGES = ("decode", "h2d", "plan", "kernel", "d2h", "encode")
STAGE_SECONDS = dict.fromkeys(STAGES, 0.0)


def reset_stage_seconds() -> None:
    for k in STAGES:
        STAGE_SECONDS[k] = 0.0


def pack_tokens(stream: np.ndarray, batch: int, seq_len: int) -> np.ndarray:
    """Pack a flat token stream into (n_batches, batch, seq_len+1) slabs
    (the +1 provides next-token labels)."""
    per = batch * (seq_len + 1)
    n = stream.shape[0] // per
    return stream[: n * per].reshape(n, batch, seq_len + 1)


def valid_row_mask(counts: Sequence[int], lengths: Sequence[int]
                   ) -> np.ndarray:
    """Which 128-token rows of the padded, fragment-concatenated stream
    hold real tokens: fragment i occupies counts[i] chunks; its first
    ceil(lengths[i] / 128) rows are content, the rest padding."""
    total = sum(counts) * CHUNK_ROWS
    valid = np.zeros(total, bool)
    row0 = 0
    for c, ln in zip(counts, lengths):
        valid[row0: row0 + -(-ln // CHUNK_COLS)] = True
        row0 += c * CHUNK_ROWS
    return valid


def merge_shards_fn(table: LogStructuredTable, task: CompactionTask,
                    out_path: str,
                    filter_fn: Optional[Callable] = None,
                    fused_filter: bool = True,
                    device: Union[str, torch.device] = "cuda"
                    ) -> Union[DataFile, Tuple[DataFile, int]]:
    """Compaction merge for token shards (kernel-backed).

    ``filter_fn(rows, task) -> keep`` makes the merge a rewrite-delete at
    128-token-row granularity: ``rows`` is the (n_rows, 128) view of the
    packed stream, ``keep`` a bool mask over it. Padding rows (beyond each
    fragment's true length) are dropped regardless of the mask, so a
    filtered merge also squeezes out inter-fragment padding; a partially
    valid boundary row that the mask keeps is kept verbatim, trailing pad
    included. Returns (DataFile, rows_dropped) -- dropped counts only
    content rows the FILTER removed, not padding.

    ``device`` is where the compaction runs: the CUDA card by default (the
    kernels), or ``"cpu"`` for the kernels' plain versions. There is no
    silent fallback: with no CUDA device the default raises.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("merge_shards_fn: no CUDA device; pass "
                           "device='cpu' to run the kernels' plain versions")
    with obs.span("act.merge") as merge:
        result, stamps = _merge(table, task, out_path, filter_fn,
                                fused_filter, device)
    for k, a, b in zip(STAGES, stamps, stamps[1:]):
        STAGE_SECONDS[k] += (b - a) * 1e-9
        obs.record("merge." + k, a, b, parent=merge)
    return result


def _merge(table, task, out_path, filter_fn, fused_filter, device):
    """:func:`merge_shards_fn`'s work; returns its result and the clock's
    readings (``obs.now``) at the start and after each stage."""
    clock = obs.now
    t0 = clock()
    payloads = []
    lengths = []
    for f in task.inputs:
        raw = table.store.get(f.path)
        payloads.append(sh.decode_shard_padded(raw))
        lengths.append(len(sh.decode_shard(raw)))
    flat = np.concatenate(payloads) if payloads else np.zeros(0, np.int32)
    counts = [p.shape[0] // CHUNK_TOKENS for p in payloads]
    chunk_map = plan_compaction(counts)
    keep = None
    if filter_fn is not None:
        # merge_shards_fn plans fragments in input order, so the packed
        # stream IS the concatenated stream and the row views coincide.
        rows = flat.reshape(-1, CHUNK_COLS) if flat.size else \
            np.zeros((0, CHUNK_COLS), np.int32)
        valid = valid_row_mask(counts, lengths)
        keep = np.asarray(filter_fn(rows, task), bool).reshape(-1) & valid
    t1 = clock()
    # np.concatenate copied the read-only store views into one writable,
    # owned buffer, so from_numpy neither warns nor aliases the store
    src = torch.from_numpy(flat).to(device)
    _sync(device)
    t2 = clock()
    if keep is not None:
        out = compact_chunks(src, chunk_map, use_ref=not fused_filter,
                             keep_mask=keep)
    else:
        out = compact_chunks(src, chunk_map)
    t3 = clock()
    _sync(device)
    t4 = clock()
    merged = out.cpu().numpy()
    t5 = clock()

    if keep is not None:
        tokens = merged[: int(keep.sum()) * CHUNK_COLS]
        raw = sh.encode_shard(tokens)
        table.store.put(out_path, raw)
        result = (DataFile(path=out_path, size_bytes=len(raw),
                           num_rows=int(tokens.shape[0]),
                           partition=task.scope, created_at=table.now_fn()),
                  int(valid.sum() - keep.sum()))
    else:
        # re-encode with the true concatenated length (drop inter-shard
        # padding bookkeeping: lengths are tracked per fragment)
        tokens = np.concatenate([
            merged[sum(c * CHUNK_TOKENS for c in counts[:i]):][:lengths[i]]
            for i in range(len(counts))]) if counts else merged[:0]
        raw = sh.encode_shard(tokens)
        table.store.put(out_path, raw)
        result = DataFile(path=out_path, size_bytes=len(raw),
                          num_rows=int(tokens.shape[0]), partition=task.scope,
                          created_at=table.now_fn())
    return result, (t0, t1, t2, t3, t4, t5, clock())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
