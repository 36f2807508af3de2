"""Public facade over the model zoo, plus the family-agnostic decode-state
surface the serve path programs against.

The port of ``src/repro/models/registry.py``:

* :func:`capabilities` -- one table of what each family's decode state
  supports, consulted by ``launch/serve.py`` and ``train/step.py``.
  :func:`require` raises the uniform refusal naming the flag, the family,
  and the missing capability.
* :class:`StateStore` -- one protocol over the per-family decode state:
  ``abstract_state / state_axes / init_state / admit_row / free_row``. A
  leaf with a ``kv_seq`` axis admits as a cache slice, a leaf without one
  (recurrent state) as a whole-row overwrite.
* :class:`PagedStateStore` -- the slot table as a pool of fixed-size
  pages with a host-owned page table.

Each operation returns new tensors and leaves its inputs as they were, as
the reference's pure functions do. A ``slot`` is a host integer here: the
engine owns the slot table on the host, so no admission needs a device
sync to find its row.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Union

import numpy as np
import torch

from repro_torch.configs import FAMILIES, ModelConfig, get_config, smoke_config  # noqa: F401
from repro_torch.dist import collectives
from repro_torch.dist import sharding as _shd
from repro_torch.models import transformer
from repro_torch.models.common import resolve_device, tree_map
from repro_torch.models.transformer import (  # noqa: F401
    TensorSpec,
    is_axes,
    abstract_cache,
    cache_axes,
    cache_struct,
    forward,
    init_cache,
    init_params,
    param_specs,
)


# ---------------------------------------------------------------------------
# capabilities
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What one family's decode state supports on the serve path.

    ``ragged``: whole-batch ragged ``prompt_lens`` (per-row masking of a
    padded batch). ``slot_stream``: per-request slot admission into a
    running decode batch. ``quantized_storage``: int8/f8-resident decode
    state. ``row_state``: the state is correct only if prefill never sees
    pad tokens (ring buffers alias junk slots into the window; recurrent
    scans fold pads into the state), so slot streaming prefills each
    request at its exact length and admits the whole row. ``paged``: the
    ``[slots, total]`` state table can serve as a paged pool
    (:class:`PagedStateStore`), sound only for full (slot == position)
    attention caches.
    """
    family: str
    ragged: bool
    slot_stream: bool
    quantized_storage: bool
    row_state: bool
    paged: bool
    why_ragged: str = ""
    why_storage: str = ""
    why_paged: str = ""


_WHY_RAGGED_RECURRENT = (
    "windowed (ring-buffer) and recurrent-state families fold pad tokens "
    "into per-row state during whole-batch prefill and per-row masks "
    "cannot undo that; serve them with --stream slots (exact-length "
    "per-request prefill) or pad to a uniform length")
_WHY_STORAGE_RECURRENT = (
    "recurrent state leaves (ssm/xlstm) accumulate quantization error "
    "across steps; only pure-attention caches are quantized-resident")
_WHY_PAGED = (
    "paging assumes a full (slot == position) cache whose unallocated "
    "pages are masked by per-row positions; ring-buffer windows alias "
    "page junk into the window and recurrent rows are O(1) per slot — "
    "there is nothing to page")

_ATTENTION_CAPS = dict(ragged=True, slot_stream=True,
                       quantized_storage=True, row_state=False, paged=True)
_RECURRENT_CAPS = dict(ragged=False, slot_stream=True,
                       quantized_storage=False, row_state=True, paged=False,
                       why_ragged=_WHY_RAGGED_RECURRENT,
                       why_storage=_WHY_STORAGE_RECURRENT,
                       why_paged=_WHY_PAGED)

_FAMILY_CAPS = {
    "dense": _ATTENTION_CAPS,
    "moe": _ATTENTION_CAPS,
    "mla": _ATTENTION_CAPS,
    "vlm": _ATTENTION_CAPS,
    "encoder_audio": _ATTENTION_CAPS,
    "hybrid": _RECURRENT_CAPS,
    "ssm_xlstm": _RECURRENT_CAPS,
}


def capabilities(cfg_or_family: Union[ModelConfig, str]) -> Capabilities:
    """The capability record for a family (or a concrete config: an
    ``attn_window`` turns any attention family into a ring buffer, which
    drops whole-batch ragged and makes slot prefill exact-length)."""
    if isinstance(cfg_or_family, str):
        family, windowed = cfg_or_family, False
    else:
        family, windowed = cfg_or_family.family, bool(cfg_or_family.attn_window)
    if family not in _FAMILY_CAPS:
        raise ValueError(f"unknown family {family!r}; "
                         f"expected one of {tuple(_FAMILY_CAPS)}")
    base = dict(_FAMILY_CAPS[family])
    if windowed and base["ragged"]:
        base.update(ragged=False, row_state=True, paged=False,
                    why_ragged=_WHY_RAGGED_RECURRENT,
                    why_paged=_WHY_PAGED)
    return Capabilities(family=family, **base)


def require(cfg: ModelConfig, capability: str, flag: str) -> None:
    """Raise the uniform refusal if ``cfg``'s family lacks ``capability``,
    naming the flag, the family and the missing capability."""
    caps = capabilities(cfg)
    if getattr(caps, capability):
        return
    why = {"ragged": caps.why_ragged,
           "quantized_storage": caps.why_storage,
           "paged": caps.why_paged}.get(capability, "")
    raise NotImplementedError(
        f"{flag} is unsupported for {cfg.name} (family={caps.family}): "
        f"missing capability {capability!r}"
        + (f" — {why}" if why else ""))


# ---------------------------------------------------------------------------
# the StateStore protocol
# ---------------------------------------------------------------------------

def _rename_batch(axes_tree, name: str):
    return tree_map(lambda la: tuple(name if a == "batch" else a for a in la),
                    axes_tree, is_leaf=is_axes)


def _write_row(leaf: torch.Tensor, row: torch.Tensor, axis: int, slot
               ) -> torch.Tensor:
    starts = [0] * leaf.ndim
    starts[axis] = int(slot)
    return collectives.update_slice(leaf, row, starts)


@dataclasses.dataclass(frozen=True)
class StateStore:
    """One family-agnostic handle on a model's decode-state table.

    ``rows`` is the slot-table size (the state's batch dim doubles as the
    slot dim), ``total`` the decode horizon (sizes attention caches;
    O(1) recurrent state ignores it). ``admit_row``/``free_row`` return a
    new state and leave the one passed in as it was.
    """
    cfg: ModelConfig
    rows: int
    total: int
    kv_storage: str = "bf16"

    def __post_init__(self):
        if self.kv_storage != "bf16":
            require(self.cfg, "quantized_storage",
                    f"kv_storage={self.kv_storage!r}")

    @property
    def caps(self) -> Capabilities:
        return capabilities(self.cfg)

    # --- layout -----------------------------------------------------------
    def abstract_state(self):
        """``TensorSpec``s of the state table in its resident layout."""
        return transformer.abstract_cache(self.cfg, self.rows, self.total,
                                          kv_storage=self.kv_storage)

    def state_axes(self):
        """Logical axes of the state table, batch dim renamed to "slots"."""
        return _rename_batch(
            transformer.cache_axes(self.cfg, self.rows, self.total,
                                   kv_storage=self.kv_storage), "slots")

    def row_axes(self):
        """Logical axes of one request's ``[1, total]`` bf16 state slice
        (the admission payload's layout)."""
        return transformer.cache_axes(self.cfg, 1, self.total)

    def abstract_row(self):
        return transformer.abstract_cache(self.cfg, 1, self.total)

    def init_state(self, device: Union[str, torch.device, None] = None):
        """A zero state table (empty rows read as masked until admitted),
        on the card unless ``device`` names another."""
        return transformer.zeros_like_spec(
            self.abstract_state(), resolve_device(device, "init_state"))

    # --- row admission ----------------------------------------------------
    def admit_row(self, state, row, slot, *, transfer: str = "bf16",
                  block: int = collectives.ACT_BLOCK):
        """Write one request's ``[1, total]`` bf16 state slice into row
        ``slot`` of the state table (in its resident layout).

        Per leaf: a ``kv_seq``-carrying leaf is a cache slice
        (``transfer="int8"`` streams it seq-blockwise through
        ``collectives.stream_slot_int8``); a leaf without one is O(1) row
        state, overwritten whole (``transfer="int8"``: feature-blockwise
        through ``collectives.stream_row_int8``).
        """
        if transfer not in collectives.CACHE_TRANSFERS:
            raise ValueError(f"unknown cache_transfer {transfer!r}; "
                             f"expected one of {collectives.CACHE_TRANSFERS}")
        if self.kv_storage != "bf16":
            return self._admit_row_quantized(state, row, slot,
                                             transfer=transfer, block=block)

        def admit(la, cur, new, sa):
            ba = la.index("batch")
            if transfer == "int8" and "kv_seq" in la:
                upd = collectives.stream_slot_int8(
                    cur, new, slot, *la, seq_axis=la.index("kv_seq"),
                    batch_axis=ba, block=block)
            elif transfer == "int8":
                upd = collectives.stream_row_int8(
                    cur, new, slot, *la, batch_axis=ba, block=block)
            else:
                upd = _write_row(cur, new, ba, slot)
            return _shd.constrain(upd, *sa)

        return tree_map(admit, self.row_axes(), state, row, self.state_axes(),
                        is_leaf=is_axes)

    def _admit_row_quantized(self, state, row, slot, *, transfer: str,
                             block: int):
        """int8/f8-resident admission: wire the bf16 slice, re-encode it
        into the storage layout (s8 + scale leaves / e4m3), write each
        storage leaf's row. Flat attention caches only."""
        row_axes = self.row_axes()
        store_axes = self.state_axes()
        out = dict(state)
        wired = {}
        for name, leaf in row.items():
            la = tuple(row_axes[name])
            if transfer == "int8" and "kv_seq" in la:
                leaf = collectives.stream_int8(
                    leaf, *la, seq_axis=la.index("kv_seq"), block=block)
            wired[name] = leaf
        store = transformer.quantize_cache(wired, self.kv_storage)
        for name, upd in store.items():
            la = tuple(store_axes[name])
            out[name] = _shd.constrain(
                _write_row(state[name], upd, la.index("slots"), slot), *la)
        return out

    def free_row(self, state, slot):
        """Zero row ``slot`` of every leaf: a freed slot reads as empty,
        not as its previous occupant."""
        def zero(la, leaf):
            ba = la.index("slots")
            shape = list(leaf.shape)
            shape[ba] = 1
            zeros = torch.zeros(shape, dtype=leaf.dtype, device=leaf.device)
            return _shd.constrain(_write_row(leaf, zeros, ba, slot), *la)
        return tree_map(zero, self.state_axes(), state, is_leaf=is_axes)


def state_store(cfg: ModelConfig, rows: int, total: int,
                kv_storage: str = "bf16") -> StateStore:
    """The StateStore for ``cfg``'s family (validates storage capability)."""
    return StateStore(cfg=cfg, rows=rows, total=total, kv_storage=kv_storage)


# ---------------------------------------------------------------------------
# the paged variant
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PagedStateStore(StateStore):
    """Paged slot table: rows are lists of fixed-size pages in a shared
    pool, so mixed-length requests allocate pages on demand instead of
    padding every row to the decode horizon.

    Every ``kv_seq``-carrying leaf of the dense ``[slots, total]`` layout
    (values and int8 scale leaves) is stored pool-form: the
    ``(slots, total)`` axes become ``(n_pool, page)``, and a host-owned
    page table ``[rows, total // page]`` of int32 pool indices (-1 =
    unallocated) maps each slot's positions onto pool pages.

    ``gather_dense``/``scatter_dense`` bracket the unchanged dense decode
    step: gather rebuilds the ``[rows, total]`` view through the page
    table (-1 clamps to page 0: junk that per-row position masks send to
    NEG_INF), the dense step runs, and scatter writes the result back,
    dropping unallocated entries. ``admit_pages`` ships only a request's
    live pages.
    """
    page: int = 256
    pool_pages: int = 0                # 0 = fully backed

    def __post_init__(self):
        super().__post_init__()
        require(self.cfg, "paged", "--paged")
        if self.page < 1:
            raise ValueError(f"page size must be >= 1, got {self.page}")
        if self.total % self.page != 0:
            raise ValueError(
                f"page size {self.page} must divide the decode horizon "
                f"{self.total} (round the horizon up or pick a divisor)")
        if self.n_pool < self.pages_per_row:
            raise ValueError(
                f"pool of {self.n_pool} pages cannot back even one "
                f"{self.pages_per_row}-page row; raise pool_pages")

    @property
    def pages_per_row(self) -> int:
        return self.total // self.page

    @property
    def n_pool(self) -> int:
        return self.pool_pages or self.rows * self.pages_per_row

    # --- layout -----------------------------------------------------------
    def _pool_axis(self, la) -> int:
        la = tuple(la)
        i = la.index("slots")
        if i + 1 >= len(la) or la[i + 1] != "kv_seq":
            raise NotImplementedError(
                f"paged leaf layout {la} lacks an adjacent "
                "(slots, kv_seq) pair")
        if i != 1:
            raise NotImplementedError(
                f"paged leaf layout {la} expects (layers, slots, kv_seq, "
                "...)")
        return i

    def dense_abstract_state(self):
        """The ``[rows, total]`` storage layout the decode step sees."""
        return super().abstract_state()

    def dense_state_axes(self):
        return super().state_axes()

    def abstract_state(self):
        """Pool-form ``TensorSpec``s: (slots, total) -> (n_pool, page)."""
        out = {}
        dense_axes = self.dense_state_axes()
        for name, leaf in self.dense_abstract_state().items():
            i = self._pool_axis(dense_axes[name])
            shape = leaf.shape[:i] + (self.n_pool, self.page) \
                + leaf.shape[i + 2:]
            out[name] = TensorSpec(shape, leaf.dtype)
        return out

    def state_axes(self):
        """Pool-form logical axes: the pool-page axis is "pages";
        positions inside a page are unsharded."""
        out = {}
        for name, la in self.dense_state_axes().items():
            i = self._pool_axis(la)
            la = tuple(la)
            out[name] = la[:i] + ("pages", None) + la[i + 2:]
        return out

    def abstract_page_table(self):
        return TensorSpec((self.rows, self.pages_per_row), torch.int32)

    def init_page_table(self) -> np.ndarray:
        """Host-owned page table, all rows unallocated."""
        return np.full((self.rows, self.pages_per_row), -1, np.int32)

    def page_bytes(self) -> int:
        """Resident bytes one pool page costs across every leaf (all
        layers)."""
        return sum(leaf.nbytes // self.n_pool
                   for leaf in self.abstract_state().values())

    # --- dense view around the unchanged decode step ----------------------
    def gather_dense(self, state, page_table):
        """The dense ``[rows, total]`` storage-layout cache, every leaf
        read through the page table. Unallocated entries (-1) clamp to
        pool page 0: junk, but only at positions beyond each row's live
        length, which decode attention masks."""
        pt = torch.as_tensor(np.asarray(page_table, np.int64))
        pt = pt.clamp(min=0).reshape(-1)
        dense_axes = self.dense_state_axes()
        out = {}
        for name, leaf in state.items():
            i = self._pool_axis(dense_axes[name])

            def gather(t, i=i):
                g = collectives.index_select(t, i, pt.to(t.device))
                return g.reshape(t.shape[:i] + (self.rows, self.total)
                                 + t.shape[i + 2:])
            out[name] = _shd.constrain(
                collectives.on_local(gather, leaf, (i, i + 1)),
                *dense_axes[name])
        return out

    def scatter_dense(self, state, dense, page_table):
        """Write a dense ``[rows, total]`` cache back into the pool;
        entries whose page-table slot is unallocated are dropped, as the
        reference's scatter drops its out-of-bounds index."""
        pt = np.asarray(page_table, np.int64).reshape(-1)
        live = np.nonzero(pt >= 0)[0]
        pool_axes = self.state_axes()
        out = {}
        for name, leaf in state.items():
            dst = torch.as_tensor(pt[live], device=leaf.device)
            src = torch.as_tensor(live, device=leaf.device)

            def scatter(pool, d):
                pages = d.reshape(pool.shape[:1] + (
                    self.rows * self.pages_per_row, self.page)
                    + pool.shape[3:])
                return collectives.index_copy(
                    pool, 1, dst, collectives.index_select(pages, 1, src))
            out[name] = _shd.constrain(
                collectives.on_local(scatter, leaf, (1, 2), dense[name]),
                *pool_axes[name])
        return out

    # --- paged admission --------------------------------------------------
    def admit_pages(self, state, slc, page_idx, *, transfer: str = "bf16",
                    block: int = collectives.ACT_BLOCK):
        """Admit one request's live pages: ``slc`` is its grown
        ``[1, n_live * page]`` bf16 state slice (junk beyond the prompt is
        masked by the row's position), ``page_idx`` the ``(n_live,)``
        freshly allocated pool destinations. The slice is wired
        (``transfer="int8"``: seq-blockwise s8 chunks + scales),
        re-encoded into the resident storage layout, and scattered
        page-wise into the pool."""
        if transfer not in collectives.CACHE_TRANSFERS:
            raise ValueError(f"unknown cache_transfer {transfer!r}; "
                             f"expected one of {collectives.CACHE_TRANSFERS}")
        page_idx = np.asarray(page_idx, np.int64).reshape(-1)
        n_live = page_idx.shape[0]
        live_len = n_live * self.page
        row_axes = transformer.cache_axes(self.cfg, 1, live_len)
        wired = {}
        for name, leaf in slc.items():
            la = tuple(row_axes[name])
            if transfer == "int8" and "kv_seq" in la:
                leaf = collectives.stream_int8(
                    leaf, *la, seq_axis=la.index("kv_seq"), block=block)
            wired[name] = leaf
        store_slc = transformer.quantize_cache(wired, self.kv_storage)
        pool_axes = self.state_axes()
        out = {}
        for name, leaf in state.items():
            idx = torch.as_tensor(page_idx, device=leaf.device)

            def admit(pool, slc):
                pages = slc.reshape(pool.shape[:1] + (n_live, self.page)
                                    + pool.shape[3:])
                return collectives.index_copy(pool, 1, idx, pages)
            out[name] = _shd.constrain(
                collectives.on_local(admit, leaf, (1, 2), store_slc[name]),
                *pool_axes[name])
        return out


def paged_state_store(cfg: ModelConfig, rows: int, total: int,
                      kv_storage: str = "bf16", page: int = 256,
                      pool_pages: int = 0) -> PagedStateStore:
    """The paged StateStore (validates the family's ``paged`` capability
    and that ``page`` divides ``total``)."""
    return PagedStateStore(cfg=cfg, rows=rows, total=total,
                           kv_storage=kv_storage, page=page,
                           pool_pages=pool_pages)
