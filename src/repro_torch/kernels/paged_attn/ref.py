"""Paged decode-attention: page-pool data movement + the plain version.

The paged slot cache stores K/V as fixed-size pages in a shared pool with
a per-slot page table; attention reads the dense per-row view back
*through* the table. Paging is pure data movement -- ``gather_pages`` is
the exact inverse of ``pack_pages`` for every live position, and
positions whose table entry is unallocated (-1) return junk that decode
attention's per-row length mask sends to -1e30 before the softmax (exp
underflows to exactly 0). That is why the page size is a provably *exact*
tunable axis: it regroups the gather, never the reduction.

Both movements are plain tensor indexing, on whichever device the
operands live; the JAX package does them outside any Pallas kernel too.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attn.ref import decode_attention_ref


def pack_pages(x: torch.Tensor, page: int):
    """Split a dense per-row array ``(B, S, ...)`` into a page pool
    ``(B * S // page, page, ...)`` plus its ``(B, S // page)`` page table.

    The pool order is a fixed non-identity permutation (reversed page
    order), so every consumer exercises a real gather rather than a
    reshape; the permutation is deterministic, keeping tuned-point sweeps
    replayable.
    """
    b, s = x.shape[:2]
    if s % page != 0:
        raise ValueError(f"page size {page} must divide the cache length {s}")
    n = b * (s // page)
    pages = x.reshape((n, page) + tuple(x.shape[2:]))
    perm = torch.arange(n - 1, -1, -1, dtype=torch.int32, device=x.device)
    # pool[j] = pages[perm[j]]; reversal is its own inverse, so the table
    # mapping dense page i -> pool index is the same permutation
    return pages[perm.long()], perm.reshape(b, s // page)


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """Dense ``(B, S, ...)`` view of a page pool read through the page
    table. Unallocated entries (-1) clamp to pool page 0 -- junk the
    caller's per-row length masks hide."""
    b, ppr = page_table.shape
    page = pool.shape[1]
    idx = torch.clamp(page_table.to(torch.int64).reshape(-1), min=0)
    g = torch.index_select(pool, 0, idx)
    return g.reshape((b, ppr * page) + tuple(pool.shape[2:]))


def paged_attention_ref(q, k, v, lengths, page: int = 256):
    """Oracle: page the dense K/V, read them back through the table, run
    plain decode attention. The roundtrip is exact, so this equals dense
    decode attention bit-for-bit for every page size."""
    kp, pt = pack_pages(k, page)
    vp, _ = pack_pages(v, page)
    return decode_attention_ref(q, gather_pages(kp, pt),
                                gather_pages(vp, pt), lengths)
