"""Public flash-decode op, registered on the tunable-op registry.

``block_k`` resolves tuned > default (512) and is clamped to the cache
length (divisor-safe), so a point tuned on a long cache can't mis-tile a
short one. ``block_k`` regroups the online-softmax accumulation, so no
axis is exact -- kernel-vs-ref matches within fp tolerance only.

A CUDA ``q`` runs the kernel; a CPU one runs its plain PyTorch version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import api
from repro_torch.kernels.decode_attn.decode_attn import (
    DEFAULT_BLOCK_K, decode_attention_kernel)
from repro_torch.kernels.decode_attn.ref import decode_attention_ref

BLOCK_CANDIDATES = (128, 256, 512, 1024)


def _run(point, q, k, v, lengths):
    return decode_attention_kernel(q, k, v, lengths,
                                   block_k=point["block_k"])


def _ref(q, k, v, lengths):
    return decode_attention_ref(q, k, v, lengths)


def _clamp(point, q, k, v, lengths, **kw):
    return {"block_k": api.fit_block(point["block_k"], k.shape[1])}


def _shape_key(q, k, v, lengths, **kw):
    b, h, d = q.shape
    dtype = str(q.dtype).removeprefix("torch.")
    return f"b{b}h{h}kv{k.shape[2]}s{k.shape[1]}d{d}:{dtype}"


def example_operands(op_name: str, quick: bool, device):
    """The decode sweep's example cell (shared with ``paged_attn``): B 4,
    H 8, Hkv 2, D 64, bf16, ragged lengths."""
    device = api.example_device(op_name, device)
    s = 512 if quick else 2048
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((4, 8, 64), generator=gen).to(torch.bfloat16)
    k = torch.randn((4, s, 2, 64), generator=gen).to(torch.bfloat16)
    v = torch.randn((4, s, 2, 64), generator=gen).to(torch.bfloat16)
    lens = torch.tensor([s, s // 2, s // 4, 100], dtype=torch.int32)
    return tuple(t.to(device) for t in (q, k, v, lens)), {}


def _example(quick: bool, device="cuda"):
    return example_operands("decode_attn", quick, device)


api.register(api.TunableOp(
    name="decode_attn",
    axes={"block_k": BLOCK_CANDIDATES},
    default={"block_k": DEFAULT_BLOCK_K},
    run=_run,
    ref=_ref,
    clamp=_clamp,
    shape_key=_shape_key,
    example=_example,
    exact_axes=frozenset(),
    tol=5e-2,
))


def decode_attention(q, k, v, lengths, *, block_k=None, use_ref=False):
    point = None if block_k is None else {"block_k": block_k}
    return api.call("decode_attn", q, k, v, lengths, point=point,
                    use_ref=use_ref)
