"""Fused RMSNorm on Hopper: one read and one write of every row.

The kernel is hand-written CUDA C++ for sm_90a in
``kernels/csrc/rmsnorm.cu`` (design notes and bound there), built by
``kernels/build.py`` and called through ``ctypes``. One warp normalises one
row; ``block_rows`` rows go to each CTA, which regroups no reduction, so
every ``block_rows`` gives the same bits.

``rmsnorm_kernel`` launches the kernel for CUDA tensors and counts the
launch in ``LAUNCHES``; for CPU tensors it runs the plain PyTorch version
(``ref.py``) and counts nothing. It never falls back from a CUDA tensor to
the plain version: what the kernel does not take, it refuses.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

DEFAULT_BLOCK_ROWS = 256

# kernel launches since the last reset
LAUNCHES: Dict[str, int] = {"rmsnorm": 0}


def reset_launches() -> None:
    LAUNCHES["rmsnorm"] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("rmsnorm")
    ptr = ctypes.c_void_p
    lib.rmsnorm_launch.argtypes = [ptr, ptr, ptr, ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_float,
                                   ctypes.c_int, ctypes.c_int, ptr]
    lib.rmsnorm_launch.restype = ctypes.c_int
    return lib


def check_operands(x: torch.Tensor, scale: torch.Tensor) -> int:
    """Refuse what the kernel does not take; return its dtype code."""
    code = build.dtype_code(x.dtype, "rmsnorm")
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: want x (R, D) and scale (D,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if scale.dtype != x.dtype or scale.device != x.device:
        raise ValueError("rmsnorm: scale must have x's dtype and device")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    if (x.shape[1] * x.element_size()) % 16 or x.data_ptr() % 16 \
            or scale.data_ptr() % 16:
        raise ValueError("rmsnorm: rows must be whole 16-byte vectors and "
                         "16-byte aligned")
    return code


def rmsnorm_kernel(x: torch.Tensor, scale: torch.Tensor, *,
                   eps: float = 1e-6,
                   block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """x: (R, D); scale: (D,) -> (R, D)."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for {x.device}")
    code = check_operands(x, scale)
    if block_rows < 1:
        raise ValueError(f"rmsnorm: block_rows must be >= 1, got {block_rows}")
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rmsnorm_launch(x.data_ptr(), scale.data_ptr(),
                                 out.data_ptr(), x.shape[0], x.shape[1],
                                 float(eps), int(block_rows), code, stream)
    build.raise_on(err, "rmsnorm")
    LAUNCHES["rmsnorm"] += 1
    return out
