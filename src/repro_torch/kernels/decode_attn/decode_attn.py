"""Flash-decode on Hopper: single-token GQA attention against a long,
ragged KV cache.

The kernel is hand-written CUDA C++ for sm_90a in
``kernels/csrc/decode_attn.cu`` (design notes and bound there), built by
``kernels/build.py`` and called through ``ctypes``. The TPU kernel's
sequential kv grid axis becomes split-K: ``split_plan`` cuts every row's
positions into ``n_split`` ranges of whole ``block_k`` tiles, one CTA per
(range, kv head, sequence), and a combine kernel merges the ranges'
online-softmax states. The split count is this wrapper's choice (enough
CTAs for every SM a few times over), not a registry axis.

``decode_attention_kernel`` launches the kernels for CUDA tensors and
counts one launch in ``LAUNCHES`` per call; for CPU tensors it runs the
plain PyTorch version (``ref.py``) and counts nothing. It never falls back
from a CUDA tensor to the plain version: what the kernel does not take, it
refuses.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attn.ref import decode_attention_ref

DEFAULT_BLOCK_K = 512
HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)  # query heads per kv head the kernel is built for
CTAS_PER_SM = 8        # split-K target: CTAs per SM

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


def split_plan(batch: int, kv_heads: int, seq: int, block_k: int,
               n_sms: int) -> Tuple[int, int]:
    """(n_split, split_len): the fewest ranges of whole ``block_k`` tiles
    that give about ``CTAS_PER_SM * n_sms`` CTAs over ``batch * kv_heads``
    (sequence, kv head) pairs. ``n_split * split_len >= seq``."""
    n_tiles = -(-seq // block_k)
    want = max(1, -(-CTAS_PER_SM * n_sms // max(1, batch * kv_heads)))
    per = -(-n_tiles // min(n_tiles, want))
    return -(-n_tiles // per), per * block_k


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
    bk = max(1, min(int(block_k), s))
    n_split, split_len = split_plan(b, hkv, s, bk, _sm_count(q.device.index
                                                             or 0))
    out = torch.empty_like(q)
    n = b * h * n_split
    scratch = torch.empty(n * (d + 2), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.decode_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), scratch[n:].data_ptr(),
            scratch[2 * n:].data_ptr(), b, h, hkv, s, d, bk, n_split,
            split_len, code, stream)
    build.raise_on(err, "decode_attn")
    LAUNCHES["decode_attn"] += 1
    return out
