"""Token-run compaction kernels: the AutoComp rewrite inner loop on Hopper.

Token shards are written in 1024-token chunks (8 rows x 128 columns), so
compacting F fragments into dense output blocks is a permutation of whole
chunks, and a rewrite-delete is that permutation with some 128-token rows
left out. Both kernels are hand-written CUDA C++ for sm_90a in
``kernels/csrc/compact_pack.cu`` (design notes and bounds there), built by
``kernels/build.py`` and called through ``ctypes``:

``compact_chunks_kernel`` -- the plain gather, ``out[i] = src[chunk_map[i]]``
over blocks of ``g * 8`` rows.

``compact_filter_kernel`` -- the fused filter+pack: every kept row of the
plan-order stream goes straight to its final output row, taken from the
``plan_filter`` tables; the tail of the last output chunk is zero-filled.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
``LAUNCHES``. For CPU tensors it runs the kernel's plain PyTorch version
(``ref.py``) instead, and counts nothing. It never falls back from a CUDA
tensor to the plain version: what the kernel does not take, it refuses.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import build

CHUNK_ROWS = 8
CHUNK_COLS = 128
CHUNK_TOKENS = CHUNK_ROWS * CHUNK_COLS  # 1024

# destination-slot sentinel for dropped rows (plan_filter's tables)
DROP_SLOT = 127

# after the constants: ref.py imports them from here
from repro_torch.kernels.compact_pack import ref  # noqa: E402

# kernel launches since the last reset, by kernel
LAUNCHES: Dict[str, int] = {"compact_chunks": 0, "compact_filter": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind the kernels' C entry points."""
    lib = build.load("compact_pack")
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.compact_chunks_launch.argtypes = [ptr, ptr, ptr, i64, i64, ptr]
    lib.compact_chunks_launch.restype = ctypes.c_int
    lib.compact_filter_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64,
                                          i64, i64, ptr]
    lib.compact_filter_launch.restype = ctypes.c_int
    return lib


def _check_operands(src: torch.Tensor, out: torch.Tensor,
                    *tables: torch.Tensor) -> None:
    if not src.is_contiguous():
        raise ValueError("compact_pack: src must be contiguous")
    for t in (src, out):
        if t.data_ptr() % 16:
            raise ValueError("compact_pack: data pointers must be 16-byte "
                             "aligned for the vector copies")
    for t in tables:
        if t.dtype != torch.int32 or t.device != src.device \
                or not t.is_contiguous():
            raise ValueError("compact_pack: index tables must be contiguous "
                             f"int32 on {src.device}, got {t.dtype} on "
                             f"{t.device}")


def compact_chunks_kernel(src: torch.Tensor, chunk_map: torch.Tensor
                          ) -> torch.Tensor:
    """Gather blocks of ``src`` according to ``chunk_map``.

    src: (n_src_blocks, rows, CHUNK_COLS) any dtype -- ``rows`` is
        CHUNK_ROWS, or a multiple of it when the plan was coarsened
    chunk_map: (n_out_blocks,) int32 on src's device
    returns (n_out_blocks, rows, CHUNK_COLS)
    """
    if src.device.type == "cpu":
        return ref.compact_chunks_ref(src, chunk_map)
    if src.device.type != "cuda":
        raise ValueError(f"compact_chunks: no kernel for {src.device}")
    n_out = chunk_map.shape[0]
    out = torch.empty((n_out,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _check_operands(src, out, chunk_map)
    block_bytes = src[0].numel() * src.element_size()
    lib = _lib()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.compact_chunks_launch(src.data_ptr(), out.data_ptr(),
                                        chunk_map.data_ptr(), n_out,
                                        block_bytes, stream)
    build.raise_on(err, "compact_chunks")
    LAUNCHES["compact_chunks"] += 1
    return out


def compact_filter_kernel(src: torch.Tensor, chunk_sel: torch.Tensor,
                          dest: torch.Tensor, out_idx: torch.Tensor,
                          n_out: int, n_kept_rows: int) -> torch.Tensor:
    """Fused filter+pack over the touched chunks of a plan.

    src: (n_src_chunks, CHUNK_ROWS, CHUNK_COLS) any dtype
    chunk_sel: (n_steps,) int32 -- source chunk per step, plan order
    dest: (n_steps * CHUNK_ROWS,) int32 -- slot of each source row within
        the output chunk ``out_idx`` starts (DROP_SLOT for dropped rows)
    out_idx: (n_steps,) int32 -- output chunk being assembled at step i
    n_out, n_kept_rows: output chunks and kept rows of the plan
    returns (n_out, CHUNK_ROWS, CHUNK_COLS), the last chunk zero-padded

    plan_filter's ``completed`` table is not taken: it drives the TPU
    kernel's carry, and here every kept row is placed directly.
    """
    if src.device.type == "cpu":
        return ref.compact_filter_tables_ref(src, chunk_sel, dest, out_idx,
                                             n_out)
    if src.device.type != "cuda":
        raise ValueError(f"compact_filter: no kernel for {src.device}")
    n_steps = chunk_sel.shape[0]
    if dest.shape[0] != n_steps * CHUNK_ROWS or out_idx.shape[0] != n_steps:
        raise ValueError("compact_filter: table lengths disagree")
    if tuple(src.shape[1:]) != (CHUNK_ROWS, CHUNK_COLS):
        raise ValueError(f"compact_filter: src must be (n, {CHUNK_ROWS}, "
                         f"{CHUNK_COLS}), got {tuple(src.shape)}")
    out = torch.empty((n_out, CHUNK_ROWS, CHUNK_COLS), dtype=src.dtype,
                      device=src.device)
    _check_operands(src, out, chunk_sel, out_idx, dest)
    row_bytes = CHUNK_COLS * src.element_size()
    lib = _lib()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.compact_filter_launch(src.data_ptr(), out.data_ptr(),
                                        chunk_sel.data_ptr(),
                                        out_idx.data_ptr(), dest.data_ptr(),
                                        n_steps, row_bytes, n_kept_rows,
                                        n_out * CHUNK_ROWS, stream)
    build.raise_on(err, "compact_filter")
    LAUNCHES["compact_filter"] += 1
    return out
