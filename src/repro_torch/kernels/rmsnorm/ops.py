"""Public fused-RMSNorm op, registered on the tunable-op registry.

``block_rows`` only tiles independent rows -- each row's variance and
scale never see another row -- so it is an exact axis: any value yields
bit-identical output, and the tuned point is purely a scheduling choice.
Clamped divisor-safe to the (flattened) row count.

A CUDA ``x`` runs the kernel; a CPU one runs its plain PyTorch version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import api
from repro_torch.kernels.rmsnorm.rmsnorm import (DEFAULT_BLOCK_ROWS,
                                                rmsnorm_kernel)
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

BLOCK_ROWS_CANDIDATES = (64, 128, 256, 512, 1024)


def _run(point, x2, scale, *, eps=1e-6):
    return rmsnorm_kernel(x2, scale, eps=eps, block_rows=point["block_rows"])


def _ref(x2, scale, *, eps=1e-6):
    return rmsnorm_ref(x2, scale, eps)


def _clamp(point, x2, scale, **kw):
    return {"block_rows": api.fit_block(point["block_rows"], x2.shape[0])}


def _shape_key(x2, scale, **kw):
    dtype = str(x2.dtype).removeprefix("torch.")
    return f"r{x2.shape[0]}d{x2.shape[1]}:{dtype}"


def _example(quick: bool, device="cuda"):
    device = api.example_device("rmsnorm", device)
    r = 512 if quick else 4096
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((r, 1024), generator=gen).to(torch.bfloat16).to(device)
    sc = torch.ones((1024,), dtype=torch.bfloat16, device=device)
    return (x, sc), {}


api.register(api.TunableOp(
    name="rmsnorm",
    axes={"block_rows": BLOCK_ROWS_CANDIDATES},
    default={"block_rows": DEFAULT_BLOCK_ROWS},
    run=_run,
    ref=_ref,
    clamp=_clamp,
    shape_key=_shape_key,
    example=_example,
    exact_axes=frozenset({"block_rows"}),
    tol=1e-1,
))


def rmsnorm(x, scale, *, eps=1e-6, block_rows=None, use_ref=False):
    """x: (..., D); scale: (D,) -> x's shape."""
    orig = x.shape
    x2 = x.reshape(-1, orig[-1])
    point = None if block_rows is None else {"block_rows": block_rows}
    out = api.call("rmsnorm", x2, scale, eps=eps, point=point,
                   use_ref=use_ref)
    return out.reshape(orig)
