"""Int8 expert all-to-all wire format, registered on the tunable-op
registry.

The port of ``src/repro/kernels/expert_a2a/ops.py``. Expert-parallel
decode dispatches each token group's capacity buffers ``(g, e, c, d)``
across the "experts" mesh axis. This op quantizes the dispatch payload
int8-blockwise along the embedding dim before that boundary, lays the s8
values and their f32 scales out over ``EP_AXES`` (under the "ep" preset on
a ``DeviceMesh``, a redistribution over the experts axis: the all-to-all),
and dequantizes on the expert shard, so the wire carries ~2x fewer bytes
than the bf16 dispatch. ``block`` is the quantization group along d, a
wire-format knob the sweep tunes. The ref path is the bf16 dispatch (the
layout constraint only), so ``tol`` bounds the int8 round trip's error.

It has no Pallas body in the reference, and so no CUDA kernel here: it is
plain quantize, reshard and dequantize on every device.
"""

from __future__ import annotations

import torch

from repro_torch.dist import collectives
from repro_torch.kernels import api

BLOCK_CANDIDATES = (64, 128, 256, 512)
DEFAULT_BLOCK = collectives.ACT_BLOCK

# the expert-parallel dispatch layout: (groups, experts, capacity, d_model)
EP_AXES = ("batch", "experts", None, "act_embed")

# calls of :func:`expert_a2a` since the last reset
_calls = [0]


def calls() -> int:
    """How many times :func:`expert_a2a` ran since the last reset."""
    return _calls[0]


def reset_calls() -> None:
    _calls[0] = 0


def _a2a_int8(xe, *, block):
    q, scales = collectives.quantize_int8_lastdim(xe, block)
    # reshard the int8 payload (+ scales), not the bf16 tensor: under the
    # "ep" preset this boundary is the expert all-to-all
    q = collectives.reshard("expert_a2a_int8", q, *EP_AXES)
    scales = collectives.reshard("expert_a2a_int8", scales, *EP_AXES[:-1],
                                 None)
    out = collectives.dequantize_int8_lastdim(q, scales)
    return collectives.reshard("expert_a2a_int8", out.to(xe.dtype), *EP_AXES)


def _run(point, xe):
    return _a2a_int8(xe, block=point["block"])


def _ref(xe):
    return collectives.reshard("expert_a2a_bf16", xe, *EP_AXES)


def _clamp(point, xe, **kw):
    return {"block": api.fit_block(point["block"], xe.shape[-1])}


def _shape_key(xe, **kw):
    g, e, c, d = xe.shape
    dtype = str(xe.dtype).removeprefix("torch.")
    return f"g{g}e{e}c{c}d{d}:{dtype}"


def _example(quick: bool, device="cuda"):
    device = api.example_device("expert_a2a", device)
    g = 2 if quick else 8
    gen = torch.Generator().manual_seed(0)
    xe = torch.randn((g, 4, 16, 256), generator=gen).to(torch.bfloat16)
    return (xe.to(device),), {}


api.register(api.TunableOp(
    name="expert_a2a",
    axes={"block": BLOCK_CANDIDATES},
    default={"block": DEFAULT_BLOCK},
    run=_run,
    ref=_ref,
    clamp=_clamp,
    shape_key=_shape_key,
    example=_example,
    tol=5e-2,
))


def expert_a2a(xe, *, block=None, use_ref=False):
    """Route the MoE dispatch tensor through the int8 wire format (tuned
    block from the persisted cache unless ``block`` is passed)."""
    _calls[0] += 1
    point = None if block is None else {"block": block}
    return api.call("expert_a2a", xe, point=point, use_ref=use_ref)
