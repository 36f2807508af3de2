"""Public compaction op: plan (host, numpy) + execute (CUDA kernel / plain).

``plan_compaction`` converts ragged fragment descriptors into the
chunk-permutation consumed by the kernel; ``compact_chunks`` executes it.
``compact_chunks(..., keep_mask=)`` is the fused filter+pack variant --
the kernel substrate for rewrite-deletes-as-compaction: the mask drops
128-token rows in ONE pass, dropped rows and fully-dropped chunks are never
read, and the output bit-matches the filter-then-pack plain version. The
data layer (repro_torch.data.packing) feeds real token shards through this.

The planners are numpy and identical to the JAX package's. The op is
registered on the tunable-op registry (repro_torch.kernels.api) as
``compact_pack`` with one axis, ``block_chunks``: the gather granularity.
The wrapper coarsens the plan to the largest grouping <= the tuned value
that the chunk map supports (runs of consecutive chunks, which fragment
plans are), so a tuned point cached from one plan can never mis-gather
another -- an unsupported grouping degrades to finer blocks,
deterministically.

A CUDA ``src_tokens`` runs the kernels; a CPU one runs their plain PyTorch
versions. The plan tables travel to the operand's device with each call.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import api
from repro_torch.kernels.compact_pack.compact_pack import (
    CHUNK_TOKENS, CHUNK_ROWS, CHUNK_COLS, DROP_SLOT,
    compact_chunks_kernel, compact_filter_kernel)
from repro_torch.kernels.compact_pack.ref import (
    compact_chunks_ref, compact_filter_ref)

BLOCK_CHUNKS_CANDIDATES = (1, 2, 4, 8, 16)


def plan_compaction(fragment_chunk_counts: Sequence[int],
                    fragment_order: Sequence[int] | None = None
                    ) -> np.ndarray:
    """Host-side planning: fragments (each a run of chunks laid out
    back-to-back in the source buffer) -> output chunk map.

    fragment_chunk_counts[i]: chunks in source fragment i.
    fragment_order: output order of fragments (default: input order).
    """
    counts = np.asarray(fragment_chunk_counts, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    order = np.arange(len(counts)) if fragment_order is None \
        else np.asarray(fragment_order)
    out: List[np.ndarray] = [starts[f] + np.arange(counts[f]) for f in order]
    if not out:
        return np.zeros((0,), np.int32)
    return np.concatenate(out).astype(np.int32)


def coarsen_plan(chunk_map: np.ndarray, n_src: int, block_chunks: int
                 ) -> Tuple[int, np.ndarray]:
    """Largest grouping g <= block_chunks the plan supports.

    A group of g output chunks can ride one block iff they map to a
    consecutive, g-aligned run of source chunks. Fragment plans are runs,
    so realistic maps coarsen well; any map degrades to g=1 rather than
    mis-gathering.
    """
    cm = np.asarray(chunk_map, dtype=np.int64)
    g = 1
    for cand in sorted(set(BLOCK_CHUNKS_CANDIDATES)):
        if cand <= g or cand > max(1, int(block_chunks)):
            continue
        if n_src % cand or cm.shape[0] % cand:
            continue
        grouped = cm.reshape(-1, cand)
        if (grouped[:, 0] % cand == 0).all() and \
           (grouped == grouped[:, :1] + np.arange(cand)).all():
            g = cand
    return g, (cm[::g] // g).astype(np.int32) if g > 1 \
        else cm.astype(np.int32)


def plan_filter(chunk_map: np.ndarray, keep_mask: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                           int]:
    """Host planning for the fused kernel: per-chunk keep counts -> the
    tables that drive the gather.

    keep_mask: (len(chunk_map) * CHUNK_ROWS,) bool over the rows of the
    *packed* (plan-order) stream, one flag per 128-token row.

    Returns (chunk_sel, dest, completed, out_idx, n_out); fully-dropped
    chunks simply do not appear in chunk_sel.
    """
    cm = np.asarray(chunk_map, dtype=np.int64)
    keep = np.asarray(keep_mask, dtype=bool).reshape(cm.shape[0], CHUNK_ROWS)
    kept_per_chunk = keep.sum(axis=1)
    touched = np.flatnonzero(kept_per_chunk > 0)
    k = kept_per_chunk[touched]
    n_kept = int(k.sum())
    n_out = -(-n_kept // CHUNK_ROWS)
    if n_kept == 0:
        z = np.zeros((0,), np.int32)
        return z, z, z, z, 0
    start = np.concatenate([[0], np.cumsum(k)[:-1]])   # kept rows before
    carry_in = start % CHUNK_ROWS
    completed = ((carry_in + k) >= CHUNK_ROWS).astype(np.int32)
    out_idx = (start // CHUNK_ROWS).astype(np.int32)
    keepr = keep[touched]
    rank = np.cumsum(keepr, axis=1) - keepr            # exclusive, per chunk
    dest = np.where(keepr, carry_in[:, None] + rank,
                    DROP_SLOT).astype(np.int32).reshape(-1)
    chunk_sel = cm[touched].astype(np.int32)
    if completed[-1] and n_kept % CHUNK_ROWS:
        # the last step completed a chunk AND spilled rows into the carry:
        # no step is assigned to the final partial output chunk yet.
        # Append a flush step (same source chunk re-read, every row
        # dropped) whose W[:8] write emits the carry zero-padded.
        chunk_sel = np.append(chunk_sel, chunk_sel[-1]).astype(np.int32)
        dest = np.append(dest, [DROP_SLOT] * CHUNK_ROWS).astype(np.int32)
        completed = np.append(completed, 0).astype(np.int32)
        out_idx = np.append(out_idx, n_out - 1).astype(np.int32)
    return (chunk_sel, dest, completed, out_idx, n_out)


def _as_chunks(src_tokens: torch.Tensor) -> torch.Tensor:
    n = src_tokens.shape[0]
    assert n % CHUNK_TOKENS == 0, n
    return src_tokens.reshape(-1, CHUNK_ROWS, CHUNK_COLS)


def _run_pack(point: Dict[str, int], src_tokens: torch.Tensor,
              chunk_map: np.ndarray,
              keep_mask: Optional[np.ndarray] = None) -> torch.Tensor:
    src3 = _as_chunks(src_tokens)
    if keep_mask is not None:
        chunk_sel, dest, _, out_idx, n_out = plan_filter(chunk_map,
                                                         keep_mask)
        if n_out == 0:
            return src_tokens.new_zeros((0,))
        n = chunk_sel.shape[0]
        # one upload for the three tables the kernel reads
        tables = torch.from_numpy(np.concatenate(
            [chunk_sel, out_idx, dest])).to(src_tokens.device)
        n_kept = int(np.count_nonzero(dest != DROP_SLOT))
        out = compact_filter_kernel(src3, tables[:n], tables[2 * n:],
                                    tables[n:2 * n], n_out, n_kept)
        return out.reshape(-1)
    g, cm = coarsen_plan(chunk_map, src3.shape[0],
                         point.get("block_chunks", 1))
    srcg = src3.reshape(-1, g * CHUNK_ROWS, CHUNK_COLS) if g > 1 else src3
    out = compact_chunks_kernel(srcg,
                                torch.from_numpy(cm).to(src_tokens.device))
    return out.reshape(-1)


def _ref_pack(src_tokens: torch.Tensor, chunk_map: np.ndarray,
              keep_mask: Optional[np.ndarray] = None) -> torch.Tensor:
    src3 = _as_chunks(src_tokens)
    cm = torch.from_numpy(np.asarray(chunk_map, np.int32)).to(
        src_tokens.device)
    if keep_mask is not None:
        if not np.asarray(keep_mask, bool).any():
            return src_tokens.new_zeros((0,))
        return compact_filter_ref(src3, cm, keep_mask).reshape(-1)
    return compact_chunks_ref(src3, cm).reshape(-1)


def _clamp(point, src_tokens, chunk_map, keep_mask=None):
    n_out = max(1, int(np.asarray(chunk_map).shape[0]))
    return {"block_chunks": api.fit_block(point.get("block_chunks", 1),
                                          n_out)}


def _shape_key(src_tokens, chunk_map, keep_mask=None):
    n_src = src_tokens.shape[0] // CHUNK_TOKENS
    suffix = "_filter" if keep_mask is not None else ""
    dtype = str(src_tokens.dtype).removeprefix("torch.")
    return (f"nsrc{n_src}_nout{np.asarray(chunk_map).shape[0]}"
            f":{dtype}{suffix}")


def _example(quick: bool):
    n_chunks = 128 if quick else 1024
    frag = 16 if quick else 64
    src = (torch.arange(n_chunks * CHUNK_TOKENS) % 971).to(torch.int32)
    cm = plan_compaction([frag] * (n_chunks // frag),
                         fragment_order=list(
                             reversed(range(n_chunks // frag))))
    return (src, cm), {}


api.register(api.TunableOp(
    name="compact_pack",
    axes={"block_chunks": BLOCK_CHUNKS_CANDIDATES},
    default={"block_chunks": 1},
    run=_run_pack,
    ref=_ref_pack,
    clamp=_clamp,
    shape_key=_shape_key,
    example=_example,
    exact_axes=frozenset({"block_chunks"}),   # pure data movement
    tol=0.0,
))


def compact_chunks(src_tokens: torch.Tensor, chunk_map: np.ndarray, *,
                   keep_mask: Optional[np.ndarray] = None,
                   block_chunks: Optional[int] = None,
                   use_ref: bool = False) -> torch.Tensor:
    """Compact a flat, CHUNK_TOKENS-aligned token buffer.

    src_tokens: (n_chunks * CHUNK_TOKENS,) -- aligned token buffer, on the
        CUDA device (kernels) or the CPU (their plain versions)
    chunk_map:  (n_out,) int32
    keep_mask:  optional (n_out * CHUNK_ROWS,) bool over the packed
        128-token rows -- fused filter+pack: returns the kept rows dense,
        zero-padded to CHUNK_TOKENS alignment
    block_chunks: explicit gather granularity override (else tuned/default)
    use_ref: run the two-pass plain version instead of the kernels
    returns (n_out * CHUNK_TOKENS,) -- or (ceil(kept / CHUNK_ROWS) *
        CHUNK_TOKENS,) when filtering
    """
    if np.asarray(chunk_map).shape[0] == 0:
        return src_tokens.new_zeros((0,))
    point = None if block_chunks is None else {"block_chunks": block_chunks}
    return api.call("compact_pack", src_tokens, chunk_map,
                    keep_mask=keep_mask, point=point, use_ref=use_ref)
