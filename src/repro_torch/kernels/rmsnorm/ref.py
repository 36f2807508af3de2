"""Plain PyTorch version of fused RMSNorm: the CPU path and the oracle."""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """f32 mean of squares; ``x * rsqrt(var + eps)`` rounded to x.dtype,
    times ``scale`` rounded to x.dtype (the product rounded again)."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)
