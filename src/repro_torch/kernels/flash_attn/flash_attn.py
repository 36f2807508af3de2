"""Causal / sliding-window GQA flash attention (training and prefill) on
Hopper.

The kernels are hand-written CUDA C++ for sm_90a in
``kernels/csrc/flash_attn.cu`` (design notes and bound there), built by
``kernels/build.py`` and called through ``ctypes``: bf16 runs on the
tensor cores (``mma.sync``), float32 on the CUDA cores. The TPU kernel's
sequential kv grid axis is a loop inside each CTA; a CTA takes
``block_q`` query rows of one (sequence, head) and walks the keys in tiles
of ``block_k``.

``block_k`` is the tile the online softmax rescales per, held in shared
memory and, for bf16, as a 16 x block_k score tile in each warp's
registers; the card takes 32, 64 or 128 (the TPU's 512-wide tiles were
sized for 16 MB of VMEM). ``block_q`` keeps the TPU's values: the CTA walks
them as 64-row sub-tiles, so it stays an exact axis.

``flash_attention_kernel`` launches the kernel for CUDA tensors and counts
the launch in ``LAUNCHES``; for CPU tensors it runs the plain PyTorch
version (``ref.py``) and counts nothing. It never falls back from a CUDA
tensor to the plain version: what the kernel does not take, it refuses.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 64
KERNEL_BLOCK_K = (32, 64, 128)     # kv tiles the kernel is built for
HEAD_DIMS = (64, 128)

# kernel launches since the last reset
LAUNCHES: Dict[str, int] = {"flash_attn": 0}


def reset_launches() -> None:
    LAUNCHES["flash_attn"] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attn")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attn_launch.argtypes = [ptr] * 4 + [i32] * 10 + [ptr]
    lib.flash_attn_launch.restype = ctypes.c_int
    return lib


def check_operands(q, k, v, block_q: int, block_k: int) -> int:
    """Refuse what the kernel does not take; return its dtype code."""
    code = build.dtype_code(q.dtype, "flash_attn")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attn: want q (B,H,S,D), k/v (B,Hkv,S,D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d or h % hkv:
        raise ValueError(f"flash_attn: q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attn: head_dim {d} not in {HEAD_DIMS}")
    if block_k not in KERNEL_BLOCK_K:
        raise ValueError(f"flash_attn: block_k {block_k} not in "
                         f"{KERNEL_BLOCK_K}")
    if block_q < 1:
        raise ValueError(f"flash_attn: block_q must be >= 1, got {block_q}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attn: {name} must have q's dtype and "
                             "device")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attn: q, k and v must be contiguous and "
                             "16-byte aligned")
    return code


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0,
                           block_q: int = DEFAULT_BLOCK_Q,
                           block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, Hkv, S, D) -> (B, H, S, D)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn: no kernel for {q.device}")
    b, h, s, d = q.shape
    bq, bk = min(int(block_q), s), int(block_k)
    code = check_operands(q, k, v, bq, bk)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            k.shape[1], s, d, int(bool(causal)), int(window), bq, bk, code,
            stream)
    build.raise_on(err, "flash_attn")
    LAUNCHES["flash_attn"] += 1
    return out
