"""Blockwise-int8 gradient compression with error feedback, and the
serve-time collectives, on one device.

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

The serve half (``collectives.py:145-417`` of the reference) carries the
activation transport and the KV storage scopes, the lastdim and seq-axis
int8 quantizers, the scale-free f8 cast, and the slot admission
primitives. On one device every reshard is the identity, but the int8
round trips stay: ``act_gather`` under ``act_transport="int8"`` changes
the values, as the reference's does on a (1, 1) mesh. Training runs
outside every serve scope, where ``act_gather`` is the identity.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.dist.sharding import constrain

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




# ---------------------------------------------------------------------------
# serve activation transport: quantized all-gathers, no error feedback
# ---------------------------------------------------------------------------

ACT_TRANSPORTS = ("bf16", "int8")
ACT_BLOCK = 256

# the prefill->decode cache handoff's wire format, and the decode-resident
# cache's storage dtype: orthogonal axes
CACHE_TRANSFERS = ("bf16", "int8")
KV_STORAGES = ("bf16", "int8", "f8")

# f8 (e4m3) resident-cache storage: scale-free, exactly half the bf16
# bytes. e4m3fn has no inf (overflow becomes nan), so the cast clips to
# the finite range first.
F8_DTYPE = torch.float8_e4m3fn
F8_MAX = 448.0


def cast_f8(x: torch.Tensor) -> torch.Tensor:
    """Clip to the f8 finite range and cast to e4m3; every element rounds
    on its own. The same byte as the reference's jitted cast for each of
    the 65,536 bf16 bit patterns, NaNs included."""
    return torch.clamp(x.float(), -F8_MAX, F8_MAX).to(F8_DTYPE)


def uncast_f8(q: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`cast_f8` (exact: every f8 value is an f32 and a
    bf16 value)."""
    return q.to(dtype)


def lastdim_blocks(d: int, block: int = ACT_BLOCK) -> Tuple[int, int]:
    """(block_size, n_blocks) the lastdim quantizer uses for a trailing dim
    of ``d``: ``block`` when it divides ``d``, else one block spanning the
    whole dim."""
    b = block if d % block == 0 else d
    return b, d // b


def quantize_int8_lastdim(x: torch.Tensor, block: int = ACT_BLOCK
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization blocked along the trailing axis only,
    so blocks never cross a row. Returns ``(q, scales)`` with ``q: int8``
    of ``x.shape`` and ``scales: float32`` of ``x.shape[:-1] +
    (n_blocks,)``."""
    d = x.shape[-1]
    b, nb = lastdim_blocks(d, block)
    blocks = x.float().reshape(tuple(x.shape[:-1]) + (nb, b))
    q, scales = _quantize_blocks(blocks)
    return q.reshape(x.shape), scales


def dequantize_int8_lastdim(q: torch.Tensor, scales: torch.Tensor
                            ) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_lastdim` (float32 out)."""
    nb = scales.shape[-1]
    d = q.shape[-1]
    blocks = q.reshape(tuple(q.shape[:-1]) + (nb, d // nb))
    return _dequantize_blocks(blocks, scales).reshape(q.shape)


# ---------------------------------------------------------------------------
# the prefill->decode cache stream and the slot admission primitives
# ---------------------------------------------------------------------------

def quantize_int8_seqaxis(x: torch.Tensor, seq_axis: int,
                          block: int = ACT_BLOCK
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise int8 along the sequence axis of a cache leaf: the leaf
    viewed with that axis trailing, then :func:`quantize_int8_lastdim`.
    Returns ``(q, scales)`` in the seq-last layout."""
    return quantize_int8_lastdim(torch.movedim(x, seq_axis, -1), block)


def dequantize_int8_seqaxis(q: torch.Tensor, scales: torch.Tensor,
                            seq_axis: int) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_seqaxis` (float32 out, the sequence
    axis back in its place)."""
    return torch.movedim(dequantize_int8_lastdim(q, scales), -1, seq_axis)


def update_slice(buf: torch.Tensor, upd: torch.Tensor, starts) -> torch.Tensor:
    """``jax.lax.dynamic_update_slice`` as a new tensor: ``upd`` written
    into a copy of ``buf`` at ``starts``, each start clamped to
    ``[0, buf.shape[i] - upd.shape[i]]`` as XLA clamps it (a negative
    start counting from the end first, as JAX reads it), so an update
    always lands whole."""
    out = buf.clone()
    idx = []
    for i, s in enumerate(starts):
        s = int(s) + (buf.shape[i] if int(s) < 0 else 0)
        s = min(max(s, 0), buf.shape[i] - upd.shape[i])
        idx.append(slice(s, s + upd.shape[i]))
    out[tuple(idx)] = upd.to(buf.dtype)
    return out


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """An f8 tensor as its raw bytes, so that indexing kernels that do not
    dispatch on float8 move it bit for bit; any other tensor as it is."""
    return t.view(torch.uint8) if t.dtype == F8_DTYPE else t


def index_select(x: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """``torch.index_select`` for every dtype, f8 included."""
    return torch.index_select(_bytes(x), dim, idx).view(x.dtype)


def index_copy(x: torch.Tensor, dim: int, idx: torch.Tensor,
               src: torch.Tensor) -> torch.Tensor:
    """``x.index_copy(dim, idx, src)`` (a new tensor) for every dtype,
    ``src`` cast to ``x``'s dtype first."""
    return _bytes(x).index_copy(dim, idx, _bytes(src.to(x.dtype))).view(x.dtype)


def _row_starts(ndim: int, axis: int, slot) -> list:
    starts = [0] * ndim
    starts[axis] = int(slot)
    return starts


def stream_int8(x: torch.Tensor, *logical_axes: Optional[str],
                seq_axis: int, block: int = ACT_BLOCK) -> torch.Tensor:
    """A cache leaf through the int8 cache stream: seq-blockwise s8 chunks
    and f32 scales, dequantized on arrival, in ``x``'s dtype. On one
    device there is no reshard, so only the round trip's rounding is
    real; ``logical_axes`` names the target layout for the multi-GPU
    slice."""
    q, scales = quantize_int8_seqaxis(x, seq_axis, block)
    return dequantize_int8_seqaxis(q, scales, seq_axis).to(x.dtype)


def stream_slot_int8(cache_leaf: torch.Tensor, new_slice: torch.Tensor, slot,
                     *logical_axes: Optional[str], seq_axis: int,
                     batch_axis: int = 1, block: int = ACT_BLOCK
                     ) -> torch.Tensor:
    """One request's cache slice through :func:`stream_int8`, written into
    row ``slot`` along ``batch_axis`` of the running decode cache leaf (a
    new tensor; the slot clamped as XLA clamps it)."""
    arrived = stream_int8(new_slice, *logical_axes, seq_axis=seq_axis,
                          block=block).to(cache_leaf.dtype)
    return update_slice(cache_leaf, arrived,
                        _row_starts(cache_leaf.ndim, batch_axis, slot))


def stream_row_int8(cache_leaf: torch.Tensor, new_row: torch.Tensor, slot,
                    *logical_axes: Optional[str], batch_axis: int = 0,
                    block: int = ACT_BLOCK) -> torch.Tensor:
    """Per-row variant for state leaves with no sequence axis (SSM conv
    and state, mLSTM C/n/m, sLSTM h/c/n/m): the row quantized blockwise
    along its trailing feature axis, dequantized, and written into row
    ``slot`` along ``batch_axis``."""
    q, scales = quantize_int8_lastdim(new_row, block)
    arrived = dequantize_int8_lastdim(q, scales).to(cache_leaf.dtype)
    return update_slice(cache_leaf, arrived,
                        _row_starts(cache_leaf.ndim, batch_axis, slot))


class _TraceScope(threading.local):
    """Thread-local value stack behind the serve-path knobs (activation
    transport, KV storage). ``None`` pushed into a scope normalizes to the
    stack's default; an empty stack reads as the default too. The
    reference's scopes act at trace time; the port's steps run eagerly,
    so a step enters its scopes around every call."""

    def __init__(self, name: str, allowed: Tuple[str, ...],
                 default: Optional[str] = None):
        self.name = name
        self.allowed = allowed
        self.default = default
        self.items: list = []

    def current(self) -> Optional[str]:
        return self.items[-1] if self.items else self.default


class _trace_scope_ctx:
    def __init__(self, stack: _TraceScope, mode: Optional[str]):
        if mode is not None and mode not in stack.allowed:
            raise ValueError(f"unknown {stack.name} {mode!r}; "
                             f"expected one of {stack.allowed}")
        self.stack = stack
        self.mode = stack.default if mode is None else mode

    def __enter__(self) -> "_trace_scope_ctx":
        self.stack.items.append(self.mode)
        return self

    def __exit__(self, *exc) -> bool:
        self.stack.items.pop()
        return False


_act_ctx = _TraceScope("act_transport", ACT_TRANSPORTS, None)


def current_act_transport() -> Optional[str]:
    """Active serve activation transport, or None outside any scope."""
    return _act_ctx.current()


def act_transport_scope(mode: Optional[str]) -> _trace_scope_ctx:
    """Scope selecting how serve activation all-gathers cross the wire:
    ``"bf16"`` (a plain reshard), ``"int8"`` (blockwise int8 chunks and
    scales) or ``None`` (no boundary). Entered by the prefill and decode
    steps; model code reads it through :func:`act_gather`."""
    return _trace_scope_ctx(_act_ctx, mode)


def all_gather_int8(x: torch.Tensor, *logical_axes: Optional[str],
                    block: int = ACT_BLOCK) -> torch.Tensor:
    """``x`` through the int8 activation gather: quantized along the
    trailing axis, dequantized, in ``x``'s dtype. On one device the
    gather moves nothing, but the round trip's rounding is real, as it is
    in the reference on a (1, 1) mesh. An int8- or f8-resident cache
    passes through unchanged: it is as small as the transport could make
    it."""
    if x.dtype in (torch.int8, F8_DTYPE):
        return constrain(x, *logical_axes)
    q, scales = quantize_int8_lastdim(x, block)
    return dequantize_int8_lastdim(q, scales).to(x.dtype)


_kv_ctx = _TraceScope("kv_storage", KV_STORAGES, "bf16")


def current_kv_storage() -> str:
    """Active decode-cache storage dtype ("bf16" outside any scope)."""
    return _kv_ctx.current()


def kv_storage_scope(mode: Optional[str]) -> _trace_scope_ctx:
    """Scope selecting the decode KV cache's resident dtype: ``"bf16"``
    (the default), ``"int8"`` (blockwise-int8 values plus f32 scales along
    the trailing feature axis) or ``"f8"`` (scale-free e4m3). Entered by
    ``make_decode_step``; attention layers read it through
    :func:`current_kv_storage`."""
    return _trace_scope_ctx(_kv_ctx, mode)


def act_gather(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The serve activation all-gather boundary: the identity outside any
    :func:`act_transport_scope` (training), a plain ``constrain`` under
    ``"bf16"``, and :func:`all_gather_int8`'s round trip under
    ``"int8"``."""
    mode = current_act_transport()
    if mode is None:
        return x
    if mode == "int8":
        return all_gather_int8(x, *logical_axes)
    return constrain(x, *logical_axes)
