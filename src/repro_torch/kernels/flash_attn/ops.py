"""Public flash-attention op, registered on the tunable-op registry.

``block_q``/``block_k`` default to the tuned point for this (shape,
dtype, device-kind) cell when one is cached, else the deterministic
default. Explicit values override; every point is clamped to the sequence
extent: ``block_q`` to a divisor, as on the TPU, so a point tuned on a
long shape degrades deterministically on a shorter one; ``block_k`` to a
kv tile the card's kernel takes, since the kernel masks a ragged end.

``block_q`` is an exact axis: retiling the query rows never regroups the
kv reduction, so outputs are bit-identical across its values. ``block_k``
splits the online softmax differently and only matches within fp
tolerance. ``block_k``'s candidates are the kv tiles the card's kernel
takes (see ``flash_attn.py``); ``block_q`` keeps the TPU's.

A CUDA ``q`` runs the kernel; a CPU one runs its plain PyTorch version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import api
from repro_torch.kernels.flash_attn.flash_attn import (
    DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q, KERNEL_BLOCK_K, flash_attention_kernel)
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

BLOCK_Q_CANDIDATES = (128, 256, 512, 1024)
BLOCK_K_CANDIDATES = KERNEL_BLOCK_K


def _run(point, q, k, v, *, causal=True, window=0):
    return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                  block_q=point["block_q"],
                                  block_k=point["block_k"])


def _ref(q, k, v, *, causal=True, window=0):
    return flash_attention_ref(q, k, v, causal=causal, window=window)


def _clamp(point, q, k, v, **kw):
    s = q.shape[2]
    # the kernel masks the keys past S, so block_k need not divide S: it
    # clamps to the smallest kv tile the kernel takes that covers
    # min(block_k, S) (a divisor of 1000 or 77 would be no tile at all)
    bk = min(int(point["block_k"]), s)
    return {"block_q": api.fit_block(point["block_q"], s),
            "block_k": next((t for t in KERNEL_BLOCK_K if t >= bk), bk)}


def _shape_key(q, k, v, **kw):
    b, h, s, d = q.shape
    dtype = str(q.dtype).removeprefix("torch.")
    return f"b{b}h{h}kv{k.shape[1]}s{s}d{d}:{dtype}"


def _example(quick: bool, device="cuda"):
    device = api.example_device("flash_attn", device)
    s = 256 if quick else 1024
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 4, s, 64), generator=gen).to(torch.bfloat16)
    k = torch.randn((1, 2, s, 64), generator=gen).to(torch.bfloat16)
    v = torch.randn((1, 2, s, 64), generator=gen).to(torch.bfloat16)
    return tuple(t.to(device) for t in (q, k, v)), {"causal": True}


api.register(api.TunableOp(
    name="flash_attn",
    axes={"block_q": BLOCK_Q_CANDIDATES, "block_k": BLOCK_K_CANDIDATES},
    default={"block_q": DEFAULT_BLOCK_Q, "block_k": DEFAULT_BLOCK_K},
    run=_run,
    ref=_ref,
    clamp=_clamp,
    shape_key=_shape_key,
    example=_example,
    exact_axes=frozenset({"block_q"}),
    tol=5e-2,
))


def flash_attention(q, k, v, *, causal=True, window=0,
                    block_q=None, block_k=None, use_ref=False):
    point = None
    if block_q is not None or block_k is not None:
        point = {"block_q": block_q or DEFAULT_BLOCK_Q,
                 "block_k": block_k or DEFAULT_BLOCK_K}
    return api.call("flash_attn", q, k, v, causal=causal, window=window,
                    point=point, use_ref=use_ref)
