"""Paged decode-attention op, registered on the tunable-op registry.

``page`` is the paged slot cache's granularity -- the axis
``tune_design`` sweeps through ``repro_torch.kernels.tune`` like any other
registered op. The op pages the dense K/V into a (reversed-order) pool,
reads them back through the page table, and runs the flash-decode kernel
(through ``decode_attention``, so at decode_attn's own tuned point), so
the sweep prices exactly the gather a paged serve path pays per step.
Paging is pure data movement (the roundtrip is the identity on every live
position), so ``page`` is an *exact* axis: every candidate produces
bit-identical output, and a server reads its page size from the tuned
cache via :func:`tuned_page_size` without re-running a sweep.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import api
from repro_torch.kernels.decode_attn.ops import (_shape_key, decode_attention,
                                                 example_operands)
from repro_torch.kernels.decode_attn.ref import decode_attention_ref
from repro_torch.kernels.paged_attn.ref import gather_pages, pack_pages

PAGE_CANDIDATES = (64, 128, 256, 512)
DEFAULT_PAGE = 256


def _repage(x, page):
    pool, pt = pack_pages(x, page)
    return gather_pages(pool, pt)


def _run(point, q, k, v, lengths):
    page = point["page"]
    return decode_attention(q, _repage(k, page), _repage(v, page), lengths)


def _ref(q, k, v, lengths):
    return decode_attention_ref(q, k, v, lengths)


def _clamp(point, q, k, v, lengths, **kw):
    return {"page": api.fit_block(point["page"], k.shape[1])}


def _example(quick: bool, device="cuda"):
    return example_operands("paged_attn", quick, device)


api.register(api.TunableOp(
    name="paged_attn",
    axes={"page": PAGE_CANDIDATES},
    default={"page": DEFAULT_PAGE},
    run=_run,
    ref=_ref,
    clamp=_clamp,
    shape_key=_shape_key,
    example=_example,
    exact_axes=frozenset({"page"}),
    tol=5e-2,
))


def paged_attention(q, k, v, lengths, *, page=None, use_ref=False):
    """Decode attention over paged K/V (dense inputs, paged internally at
    ``page``; tuned > default when None)."""
    point = None if page is None else {"page": page}
    return api.call("paged_attn", q, k, v, lengths, point=point,
                    use_ref=use_ref)


def tuned_page_size(total: int, *, batch: int = 1, heads: int = 8,
                    kv_heads: int = 2, head_dim: int = 64,
                    dtype=torch.bfloat16) -> int:
    """The page size serving should use for a ``total``-position cache:
    the persisted tuned point for the matching sweep cell when one
    exists, the registry default otherwise -- clamped to divide ``total``
    (divisor-safe, like every tuned block). The shape key is built from
    ``meta`` tensors, which hold a shape and no data."""
    op = api.get_op("paged_attn")
    q = torch.empty((batch, heads, head_dim), dtype=dtype, device="meta")
    kv = torch.empty((batch, total, kv_heads, head_dim), dtype=dtype,
                     device="meta")
    lens = torch.empty((batch,), dtype=torch.int32, device="meta")
    point = api.resolve_point(op, q, kv, kv, lens)
    return api.fit_block(point["page"], total)
