"""Plain PyTorch versions of the compaction kernels.

``compact_chunks_ref`` and ``compact_filter_ref`` are the counterparts of
the JAX package's oracles; ``compact_filter_tables_ref`` computes the fused
kernel's function from the same ``plan_filter`` tables the kernel reads, so
the kernel's indexing is held to account on the CPU too.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.compact_pack.compact_pack import (
    CHUNK_COLS, CHUNK_ROWS, DROP_SLOT)


def compact_chunks_ref(src: torch.Tensor, chunk_map: torch.Tensor
                       ) -> torch.Tensor:
    return torch.index_select(src, 0, chunk_map.to(torch.int64))


def compact_filter_ref(src: torch.Tensor, chunk_map: torch.Tensor,
                       keep_mask: np.ndarray) -> torch.Tensor:
    """Filter-then-pack: gather EVERY planned chunk, re-read the packed
    rows, drop the masked ones, zero-pad to chunk alignment. Two full
    passes over the data -- the round trip the fused kernel removes.

    src: (n_src_chunks, CHUNK_ROWS, CHUNK_COLS)
    keep_mask: (len(chunk_map) * CHUNK_ROWS,) bool over the packed rows
    returns (ceil(n_kept / CHUNK_ROWS), CHUNK_ROWS, CHUNK_COLS)
    """
    keep = np.asarray(keep_mask, dtype=bool).reshape(-1)
    packed = torch.index_select(src, 0, chunk_map.to(torch.int64))  # pass 1
    rows = packed.reshape(-1, CHUNK_COLS)                           # pass 2
    kept_idx = torch.from_numpy(np.flatnonzero(keep)).to(src.device)
    kept = torch.index_select(rows, 0, kept_idx)
    pad = (-kept.shape[0]) % CHUNK_ROWS
    if pad:
        kept = torch.cat([kept, kept.new_zeros((pad, CHUNK_COLS))])
    return kept.reshape(-1, CHUNK_ROWS, CHUNK_COLS)


def compact_filter_tables_ref(src: torch.Tensor, chunk_sel: torch.Tensor,
                              dest: torch.Tensor, out_idx: torch.Tensor,
                              n_out: int) -> torch.Tensor:
    """The fused kernel's function, from its tables: row j of step i lands
    at output row ``8 * out_idx[i] + dest[8 * i + j]`` unless it is
    DROP_SLOT; rows no kept row reaches stay zero."""
    rows = torch.index_select(src, 0, chunk_sel.to(torch.int64)
                              ).reshape(-1, CHUNK_COLS)
    d = dest.to(torch.int64)
    target = CHUNK_ROWS * out_idx.to(torch.int64).repeat_interleave(
        CHUNK_ROWS) + d
    kept = d != DROP_SLOT
    out = src.new_zeros((n_out * CHUNK_ROWS, CHUNK_COLS))
    out[target[kept]] = rows[kept]
    return out.reshape(n_out, CHUNK_ROWS, CHUNK_COLS)
