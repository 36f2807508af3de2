"""Blockwise-int8 gradient compression with error feedback, and the
serve-time scopes of the collectives, on one device.

The port of ``src/repro/dist/collectives.py``. The train step's
``grad_transport="int8_ef"`` quantizes each gradient leaf to symmetric
int8 per ``block`` elements and carries the quantization residual into the
next step (:func:`compressed_psum`). On one device there is no reduction:
the quantization error and the residual carry are real, only the wire is
not, as in the reference's ``axis_name=None`` form. The two-stage int8
exchange across devices (``_two_stage_int8_psum``) waits for the
multi-GPU slice (ROADMAP queue 1, item 3), and so does any ``axis_name``.

The reference always runs jitted, and XLA on the CPU rounds two steps
differently from eager torch: it turns ``amax / 127.0`` into a product
with the f32 reciprocal, and it fuses the residual ``carry - q * s`` into
one rounding. The port takes both, so its outputs and residuals equal the
jitted reference's bit for bit.

Training runs outside every serve scope, so the model code sees what the
JAX package's sees there: no activation transport, a bf16 decode cache,
and an activation all-gather that is the identity. The serve quantizers
(``quantize_int8_lastdim`` and the rest) come with serving.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# XLA's rewrite of ``/ 127.0``: a product with the reciprocal in f32
_INV_127 = float(np.float32(1.0 / 127.0))


def _require_one_device(axis_name: Optional[str]) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            f"compressed_psum over axis {axis_name!r}: the two-stage int8 "
            "exchange across devices comes with the multi-GPU slice "
            "(ROADMAP queue 1, item 3); on one device pass axis_name=None")


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block int8 quantization.

    Flattens ``x``, zero-pads to a multiple of ``block``, and scales each
    block by its abs-max so values land in [-127, 127]. Returns
    ``(q, scales)`` with ``q: int8 (n_blocks, block)`` and
    ``scales: float32 (n_blocks,)``.
    """
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return _quantize_blocks(flat.reshape(-1, block))


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`; returns the first ``n`` elements."""
    return _dequantize_blocks(q, scales).reshape(-1)[:n]


def _quantize_blocks(blocks: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the trailing ``block`` axis of ``(..., block)``."""
    scales = blocks.abs().amax(dim=-1) * _INV_127
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    # torch.round, like jnp.round, rounds halves to even
    q = torch.clamp(torch.round(blocks / safe[..., None]), -127, 127)
    return q.to(torch.int8), scales


def _dequantize_blocks(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return q.float() * scales[..., None]


def compressed_psum(x: torch.Tensor, axis_name: Optional[str] = None,
                    err: Optional[torch.Tensor] = None, *, block: int = 256
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8-compressed payload with error-feedback accumulation.

    The carried residual ``err`` (same shape as ``x``, float32; zeros or
    ``None`` on the first step) is added before quantization, and the new
    residual ``(x + err) - dequantized`` is returned for the next step.
    Returns ``(summed, new_err)``: ``summed`` in ``x``'s dtype, ``new_err``
    in float32. Only ``axis_name=None``, the single-device form.
    """
    _require_one_device(axis_name)
    xf = x.float()
    carry = xf if err is None else xf + err.float()
    q, scales = quantize_int8(carry, block)
    n = carry.numel()
    deq = dequantize_int8(q, scales, n).reshape(carry.shape)
    # one rounding, as XLA's fused multiply-subtract: q * s is exact in
    # f64 (8 by 24 bits) and so is the difference, which then rounds once
    exact = q.double() * scales.double()[:, None]
    new_err = (carry.double() - exact.reshape(-1)[:n].reshape(carry.shape))
    return deq.to(x.dtype), new_err.float()


def current_act_transport() -> Optional[str]:
    """Active serve activation transport: None, as outside any scope."""
    return None


def current_kv_storage() -> str:
    """Active decode-cache storage dtype: ``"bf16"``, the default."""
    return "bf16"


def act_gather(x, *logical_axes: Optional[str]):
    """The serve activation all-gather: the identity outside a transport
    scope, which is everywhere on one device."""
    return x
