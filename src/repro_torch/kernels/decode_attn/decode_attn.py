"""Flash-decode on Hopper: single-token GQA attention against a long,
ragged KV cache.

The kernel is hand-written CUDA C++ for sm_90a in
``kernels/csrc/decode_attn.cu`` (design notes and bound there), built by
``kernels/build.py`` and called through ``ctypes``. The TPU kernel's
sequential kv grid axis becomes a split by live positions: every (sequence,
kv head) row holds ``ceil(live / block_k)`` tiles, and one CTA per SM takes
an equal, contiguous share of all rows' tiles, planned on the card from
``lengths`` (the wrapper never reads them). A combine kernel merges each
row's pieces. ``work_plan`` below mirrors the kernel's plan in Python, so
the CPU tests can hold it; ``max_pieces`` sizes the partials from the shape
alone.

``decode_attention_kernel`` launches the kernels for CUDA tensors and
counts one launch in ``LAUNCHES`` per call; for CPU tensors it runs the
plain PyTorch version (``ref.py``) and counts nothing. It never falls back
from a CUDA tensor to the plain version: what the kernel does not take, it
refuses.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attn.ref import decode_attention_ref

DEFAULT_BLOCK_K = 512
HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)  # query heads per kv head the kernel is built for
# the largest block_k: the ring is sized so that this tile's scores fit
# beside it (the source's kMaxBlockK; tests/test_torch_decode_plan.py)
MAX_BLOCK_K = 1024

# kernel launches since the last reset
LAUNCHES: Dict[str, int] = {"decode_attn": 0}


def reset_launches() -> None:
    LAUNCHES["decode_attn"] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attn")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.decode_attn_launch.argtypes = [ptr] * 8 + [i32] * 9 + [ptr]
    lib.decode_attn_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def row_live(length: int, seq: int) -> int:
    """Positions a row walks: a row with length <= 0 walks all S."""
    return min(length, seq) if length > 0 else seq


def busy_ctas(grid: int, total: int) -> int:
    """CTAs that get work: at most one per tile, so each holds a tile and
    a row's pieces are numbered without gaps."""
    return min(grid, total)


def cta_lo(c: int, total: int, n_ctas: int) -> int:
    """First global tile of CTA ``c``."""
    return c * total // n_ctas


def cta_of(x: int, total: int, n_ctas: int) -> int:
    """The CTA whose range holds global tile ``x``."""
    c = x * n_ctas // total
    while c + 1 < n_ctas and cta_lo(c + 1, total, n_ctas) <= x:
        c += 1
    while c > 0 and cta_lo(c, total, n_ctas) > x:
        c -= 1
    return c


def max_pieces(seq: int, block_k: int, n_ctas: int) -> int:
    """Most pieces one row can be cut into, from the shape alone: a piece
    holds at least one of the row's tiles, and each CTA adds at most one."""
    return max(1, min(n_ctas, -(-seq // block_k)))


class Piece(NamedTuple):
    cta: int
    b: int
    kvh: int
    piece: int        # index among the row's partials
    lo: int           # positions [lo, hi) of the row
    hi: int


def work_plan(lengths, kv_heads: int, seq: int, block_k: int,
              n_ctas: int) -> List[Piece]:
    """The split kernel's plan: rows in (b, kv head) order, each of
    ``ceil(live / block_k)`` tiles; of n = min(n_ctas, T) busy CTAs, CTA c
    takes global tiles [c T / n, (c + 1) T / n); its part of one row is a
    piece."""
    tiles = [-(-row_live(int(n), seq) // block_k) for n in lengths]
    starts, total = [], 0
    for b, nt in enumerate(tiles):
        for h in range(kv_heads):
            starts.append((total, b, h, nt))
            total += nt
    n_ctas = busy_ctas(n_ctas, total)
    out = []
    for first, b, h, nt in starts:
        live = row_live(int(lengths[b]), seq)
        c0 = cta_of(first, total, n_ctas)
        for c in range(c0, cta_of(first + nt - 1, total, n_ctas) + 1):
            t_lo = max(cta_lo(c, total, n_ctas), first) - first
            t_hi = min(cta_lo(c + 1, total, n_ctas), first + nt) - first
            out.append(Piece(c, b, h, c - c0, t_lo * block_k,
                             min(t_hi * block_k, live)))
    return sorted(out)


def check_operands(q, k, v, lengths) -> int:
    """Refuse what the kernel does not take; return its dtype code."""
    code = build.dtype_code(q.dtype, "decode_attn")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attn: want q (B,H,D), k/v (B,S,Hkv,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, d = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % hkv:
        raise ValueError(f"decode_attn: q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attn: head_dim {d} not in {HEAD_DIMS}")
    if k.shape[1] < 1:
        raise ValueError("decode_attn: the cache must hold a position")
    if h // hkv not in GROUPS:
        raise ValueError(f"decode_attn: {h // hkv} query heads per kv head, "
                         f"the kernel takes {GROUPS}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"decode_attn: {name} must have q's dtype and "
                             "device")
    if lengths.dtype != torch.int32 or lengths.device != q.device \
            or lengths.shape != (b,):
        raise ValueError(f"decode_attn: lengths must be ({b},) int32 on "
                         f"{q.device}")
    for t in (q, k, v, lengths):
        if not t.is_contiguous():
            raise ValueError("decode_attn: operands must be contiguous")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("decode_attn: q, k and v must be 16-byte aligned")
    return code


@functools.lru_cache(maxsize=256)
def launch_plan(seq: int, block_k: int, n_sms: int):
    """(block_k, CTAs, partials per (b, h)) of a launch: ``block_k`` clamped
    to the cache, one CTA per SM (a CTA's ring takes most of an SM's shared
    memory), the partials sized from the shape alone. Refuses a ``block_k``
    above ``MAX_BLOCK_K``."""
    bk = max(1, min(int(block_k), seq))
    if bk > MAX_BLOCK_K:
        raise ValueError(f"decode_attn: block_k {bk} is above "
                         f"{MAX_BLOCK_K}, whose scores the ring leaves room "
                         "for")
    return bk, n_sms, max_pieces(seq, bk, n_sms)


def decode_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lengths: torch.Tensor, *,
                            block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """q: (B, H, D); k, v: (B, S, Hkv, D); lengths: (B,) -> (B, H, D)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn: no kernel for {q.device}")
    code = check_operands(q, k, v, lengths)
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    bk, n_ctas, pieces = launch_plan(s, block_k,
                                     _sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    n = b * h * pieces
    scratch = torch.empty(n * (d + 2), dtype=torch.float32, device=q.device)
    m_part = scratch.data_ptr()   # then l (n floats), then acc (n * d)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.decode_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), m_part, m_part + 4 * n, m_part + 8 * n, b, h,
            hkv, s, d, bk, n_ctas, pieces, code, stream)
    build.raise_on(err, "decode_attn")
    LAUNCHES["decode_attn"] += 1
    return out
