"""Causal / sliding-window GQA flash attention (training and prefill) on
Hopper.

The kernels are hand-written CUDA C++ for sm_90a in
``kernels/csrc/flash_attn.cu`` (design notes and bound there), built by
``kernels/build.py`` and called through ``ctypes``: bf16 runs on the
tensor cores (``wgmma``, fed by TMA from a producer warpgroup), float32 on
the CUDA cores. The TPU kernel's sequential kv grid axis is a loop inside
each CTA; a CTA takes ``block_q`` query rows of one (sequence, head) and
walks the keys in tiles of ``block_k``.

``block_k`` is the tile the online softmax rescales per, held in a ring of
shared stages and, for bf16, as a 64 x block_k score tile in each consumer
warpgroup's registers; the card takes 32, 64 or 128 (the wgmma widths; the
TPU's 512-wide tiles were sized for 16 MB of VMEM). ``block_q`` keeps the
TPU's values: the bf16 CTA walks its rows as 64-row warpgroup tiles at
multiples of 64, the f32 CTA as 32-row sub-tiles, so it stays an exact
axis.

``launch_plan`` is the launch the wrapper hands the C entry point: threads,
ring stages, dynamic shared memory and grid. The entry point refuses a
plan that does not fit the kernel.

``flash_attention_kernel`` launches the kernel for CUDA tensors and counts
the launch in ``LAUNCHES``; for CPU tensors it runs the plain PyTorch
version (``ref.py``) and counts nothing. It never falls back from a CUDA
tensor to the plain version: what the kernel does not take, it refuses.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 64
KERNEL_BLOCK_K = (32, 64, 128)     # kv tiles the kernel is built for
HEAD_DIMS = (64, 128)

# the bf16 kernel: a producer warpgroup and two consumer warpgroups of 64
# query rows each; K/V stages of block_k rows in a ring of at most
# MAX_STAGES, within the shared memory one block may use (H100)
WG_ROWS = 64
CONSUMERS = 2
BF16_THREADS = 128 * (1 + CONSUMERS)
F32_THREADS = 128
MAX_STAGES = 4
SMEM_ALIGN = 1024          # the 128-byte swizzle's period
SMEM_LIMIT = 232448
MAX_GRID_Y = 65535         # the grid's second axis runs over B * H


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    threads: int
    stages: int
    smem: int              # dynamic shared memory, bytes
    grid: Tuple[int, int]  # (query blocks, B * H)


def bf16_smem_bytes(d: int, block_k: int, stages: int) -> int:
    """Alignment slack, both consumers' query rows, the K/V ring and its
    2 * stages + 2 mbarriers (``bf16_smem_bytes`` in the source)."""
    return (SMEM_ALIGN + CONSUMERS * WG_ROWS * d * 2
            + stages * 2 * block_k * d * 2 + 8 * (2 * stages + 2))


def launch_plan(b: int, h: int, s: int, d: int, block_q: int, block_k: int,
                code: int) -> LaunchPlan:
    """The launch of one call; ``code`` is the dtype code (1 bf16)."""
    grid = (-(-s // block_q), b * h)
    if code != build.DTYPE_CODES["bfloat16"]:
        return LaunchPlan(F32_THREADS, 1, 2 * block_k * d * 4, grid)
    stages = MAX_STAGES
    while stages > 2 and bf16_smem_bytes(d, block_k, stages) > SMEM_LIMIT:
        stages -= 1
    return LaunchPlan(BF16_THREADS, stages,
                      bf16_smem_bytes(d, block_k, stages), grid)


# kernel launches since the last reset
LAUNCHES: Dict[str, int] = {"flash_attn": 0}


def reset_launches() -> None:
    LAUNCHES["flash_attn"] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attn")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attn_launch.argtypes = [ptr] * 4 + [i32] * 14 + [ptr]
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
    if b * h > MAX_GRID_Y:
        raise ValueError(f"flash_attn: B * H = {b * h} exceeds the grid's "
                         f"{MAX_GRID_Y} (head, sequence) blocks")
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
    plan = launch_plan(b, h, s, d, bq, bk, code)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            k.shape[1], s, d, int(bool(causal)), int(window), bq, bk, code,
            plan.threads, plan.stages, plan.smem, plan.grid[0], stream)
    build.raise_on(err, "flash_attn")
    LAUNCHES["flash_attn"] += 1
    return out
