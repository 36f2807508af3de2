"""Serving launcher: batched prefill + decode with a KV cache, on one
device or across ranks, with the int8 and f8 resident caches, quantized
activation gathers, disaggregated prefill/decode, slot streaming and the
fan-in engine.

The port of ``src/repro/launch/serve.py``.
``python -m repro_torch.launch.serve --arch granite-3-8b`` runs a batched
generation loop on the reduced smoke config (``--full`` serves the
published config) on the card; ``--device cpu`` runs it on the host.
Under ``torchrun --nproc-per-node N`` every rank joins one process group
and serves on a ``(data, model)`` ``DeviceMesh`` over the ranks.

Modes, each as the reference's:

* whole-batch serving (``stream="batch"``): uniform or ragged
  (``prompt_lens``) prompts, prefilled together and decoded together;
  ``mesh`` (a ``DeviceMesh``) lays the parameters out by
  ``param_axes``, the cache by ``cache_axes``, under ``rules`` (default
  ``serve_sp``: the cache over data x model, the residual stream over
  sequence);
* ``kv_storage`` "bf16", "int8" (s8 values + f32 scales per block of the
  feature axis) or "f8" (scale-free e4m3) for the decode-resident cache;
* ``act_transport`` "bf16" or "int8": the activation gathers move s8
  values and f32 scales instead of the raw payload; on one device the
  gather moves nothing but the round trip's rounding is real;
* ``decode_mesh``: prefill on ``mesh``, decode on ``decode_mesh``
  (``serve_decode``: cache resident per batch shard), the cache moved
  between the ranks by :func:`make_cache_mover`, bf16 or seq-blockwise
  int8 on the wire (``cache_transfer``);
* ``stream="slots"``: each request prefilled alone and admitted into a
  free row of a running decode batch;
* the fan-in engine (``workers > 1`` or ``paged=True``): prefill workers,
  on their own meshes with ``prefill_meshes``, feed one slot table
  through ``dist.fanin.AdmissionArbiter``, with priority classes,
  recompute preemption (``evict``) and an optional paged slot table.

Across ranks there is one process per rank, not one controller: every
rank runs the same host loop with the same arguments. A rank issues the
compute of the meshes it belongs to and no other; the first token of a
prefill and every decoded token are broadcast from the mesh that made
them to every rank, so the arbiter's decisions, the tokens and the stats
are the same on every rank. Every rank builds every sub-mesh
(``new_group`` is collective).

Eager torch has no asynchronous dispatch of whole programs: a prefill
shipment and the decode steps are enqueued in the order the host issues
them. The engine admits in the arbiter's order exactly as the reference
does, so ``admissions``, ``evictions``, ``requeues`` and
``decode_steps`` equal the reference's. The reference writes caches with
``dynamic_update_slice``, which clamps a start so the update fits; every
start this module writes lies inside its buffer by construction, and
``update_slice`` clamps as XLA does where a start comes from a caller.

Sampling (``temperature > 0``) draws from a ``torch.Generator`` seeded by
``seed``: the same seed gives the same tokens, but not
``jax.random.categorical``'s. Greedy decoding gives the reference's tokens.

The reference prices the disaggregated design space by the compiled
programs' HLO collective bytes; :func:`disagg_decode_report` runs each
transfer, slot admission and decode step once on the mesh and counts
every collective it issues with ``launch.analysis.collective_meter``,
priced by the reference's ring model.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from collections import deque
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.configs import get_config, smoke_config
from repro_torch.dist import collectives, fanin
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import (init_ranks, make_local_mesh,
                                     pick_backend)
from repro_torch.models import registry, transformer
from repro_torch.models.common import (resolve_device, tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.models.transformer import is_axes, is_tensor_spec
from repro_torch.train import step as step_lib

STREAMS = ("batch", "slots")

def _fit_leaf(c, tgt):
    """One leaf sliced to ``tgt``'s extent, then end-padded with zeros to
    it, in ``tgt``'s dtype; a DTensor keeps its layout (the dims that
    change are made whole first)."""
    if tuple(c.shape) == tgt.shape:
        return c.to(tgt.dtype)

    def fit(t):
        t = t[tuple(slice(0, min(s, n)) for s, n in zip(t.shape, tgt.shape))]
        shape = [n if s != n else s for s, n in zip(c.shape, tgt.shape)]
        shape = [n if d in dims else s for d, (s, n) in
                 enumerate(zip(t.shape, shape))]
        out = torch.zeros(shape, dtype=tgt.dtype, device=t.device)
        out[tuple(slice(0, s) for s in t.shape)] = t.to(tgt.dtype)
        return out

    dims = tuple(d for d, (s, n) in enumerate(zip(c.shape, tgt.shape))
                 if s != n)
    return collectives.on_local(fit, c, dims)


def grow_cache(cache, target):
    """Grow every cache leaf to the decode-horizon shape (end-padding).

    ``target`` is the decode cache's ``TensorSpec`` tree, so windowed, SSM
    and xLSTM states are handled uniformly: leaves already at the target
    shape only cast, anything smaller pads with zeros at the end of each
    dimension (new slots read as empty and are masked by slot-position
    validity until written). A DTensor leaf keeps its layout.
    """
    def grow(tgt, c):
        if any(s > t for s, t in zip(c.shape, tgt.shape)):
            raise ValueError(f"grow_cache: leaf {tuple(c.shape)} is larger "
                             f"than its target {tgt.shape}")
        return _fit_leaf(c, tgt)

    return tree_map(grow, target, cache, is_leaf=is_tensor_spec)


def fit_cache(cache, target):
    """:func:`grow_cache` that can also shrink: every leaf is sliced to
    the target extent before padding. A fresh paged admission ships
    ``ceil(len / page)`` pages, which may be fewer positions than the
    ``[1, S0]`` prefill buffer (the dropped tail is pad junk beyond the
    request's live length), while a readmitted request's exact-length
    prefill pads up to the next page boundary.
    """
    return tree_map(lambda tgt, c: _fit_leaf(c, tgt), target, cache,
                    is_leaf=is_tensor_spec)


def make_cache_transfer_step(cfg, batch: int, total: int, mode: str,
                             block: int = collectives.ACT_BLOCK):
    """Single-mesh form of the prefill->decode cache handoff.

    Returns ``transfer(cache) -> cache`` that reshards every leaf to the
    layout the active ``axis_rules`` context resolves for its logical
    axes (counted as ``cache_stream_bf16``); ``mode="int8"`` routes leaves
    with a sequence axis through ``collectives.stream_int8`` (seq-blockwise
    s8 chunks + scales on the wire, ``block`` positions per chunk,
    counted as ``cache_stream_int8``), everything else (recurrent state,
    ``mode="bf16"``) moves raw. On one device nothing crosses a wire; the
    int8 round trip's rounding is real.
    """
    if mode not in collectives.CACHE_TRANSFERS:
        raise ValueError(f"unknown cache_transfer {mode!r}; "
                         f"expected one of {collectives.CACHE_TRANSFERS}")
    axes = transformer.cache_axes(cfg, batch, total)

    def transfer(cache):
        def move(la, leaf):
            if mode == "int8" and "kv_seq" in la:
                return collectives.stream_int8(
                    leaf, *la, seq_axis=la.index("kv_seq"), block=block)
            return collectives.reshard("cache_stream_bf16", leaf, *la)
        return tree_map(move, axes, cache, is_leaf=is_axes)
    return transfer


# ---------------------------------------------------------------------------
# meshes over ranks: membership, placement, the tokens every rank needs
# ---------------------------------------------------------------------------

def _ranked(mesh) -> bool:
    return mesh is not None and shd.is_device_mesh(mesh)


def _member(mesh) -> bool:
    """Whether this process computes on ``mesh`` (always, off ranks)."""
    return not _ranked(mesh) or mesh.get_coordinate() is not None


def mesh_ranks(mesh) -> tuple:
    """The global ranks of a ``DeviceMesh``, row-major; ``()`` for the
    one-process mesh."""
    if not _ranked(mesh):
        return ()
    return tuple(int(r) for r in mesh.mesh.reshape(-1).tolist())


def _source(mesh) -> Optional[int]:
    """The rank whose tokens every rank takes when ``mesh`` leaves some
    ranks out, else ``None`` (every rank computes them itself)."""
    if not _ranked(mesh) or len(mesh_ranks(mesh)) == dist.get_world_size():
        return None
    return mesh_ranks(mesh)[0]


def _share(values: np.ndarray, src: Optional[int]) -> np.ndarray:
    """``values`` as rank ``src`` holds them, on every rank."""
    if src is None:
        return values
    t = torch.as_tensor(np.ascontiguousarray(values, np.int32))
    return collectives.broadcast(t, src=src).numpy()


def _context(mesh, rules):
    return shd.axis_rules(mesh, rules) if mesh is not None \
        else contextlib.nullcontext()


def _place(tree, axes, mesh, rules):
    """``tree`` laid out on ``mesh`` by its logical axes (each rank keeps
    its shard, moving nothing); as it is off ranks or outside ``mesh``."""
    if _ranked(mesh) and _member(mesh):
        return shd.distribute_tree(tree, axes, mesh, rules)
    return tree


def _commit(tree, axes):
    """Every DTensor leaf of ``tree`` resharded to its logical axes under
    the active context."""
    return tree_map(lambda la, t: collectives.reshard("reshard", t, *la),
                    axes, tree, is_leaf=is_axes)


def _full(x: torch.Tensor) -> torch.Tensor:
    return x.full_tensor() if shd.is_dtensor(x) else x


def _shard_region(shape, place, mesh, rank: int) -> tuple:
    """The slices of a ``shape`` array that ``rank`` holds when it is laid
    out by ``place`` on ``mesh`` (even shards, major to minor)."""
    coord = [int(c[0]) for c in np.nonzero(
        mesh.mesh.numpy() == rank)]
    lo, size = [0] * len(shape), list(shape)
    for m, p in enumerate(place):
        if p.is_shard():
            d = p.dim % len(shape)
            size[d] //= mesh.size(m)
            lo[d] += coord[m] * size[d]
    return tuple(slice(a, a + n) for a, n in zip(lo, size))


def make_cache_mover(cfg, batch: int, total: int, dec_mesh, dec_rules,
                     mode: str, dst_shardings, src_mesh=None):
    """The two-mesh cache handoff: returns ``move(cache) -> cache``,
    placing a prefill cache (or a single request's ``batch=1`` slice)
    laid out on ``src_mesh``'s ranks onto ``dec_mesh`` in the layout
    ``dst_shardings`` gives (``sharding.tree_shardings`` of the cache).

    Every rank calls ``move``: a prefill rank with its cache, any other
    rank with ``None``; a decode rank gets its shards back, any other
    rank ``None``. Per leaf, prefill rank ``j`` sends each decode rank
    ``i`` with ``i % n_prefill == j`` the region of the leaf that rank
    holds. ``"bf16"`` sends the leaf's values (counted as
    ``cache_move_bf16``); ``"int8"`` quantizes each sequence-carrying
    leaf blockwise along the sequence axis on the prefill ranks, sends
    only the s8 chunks and the f32 scales (``cache_move_int8``, ~1/2 the
    bf16 bytes) and dequantizes on the decode ranks. Leaves without a
    sequence axis move raw. Off ranks (the one-process mesh) ``"bf16"``
    is the identity and ``"int8"`` the round trip, as the reference's
    ``device_put`` on a (1, 1) mesh. Built once per width; the slot
    streamer calls ``move`` on each admission.
    """
    if mode not in collectives.CACHE_TRANSFERS:
        raise ValueError(f"unknown cache_transfer {mode!r}; "
                         f"expected one of {collectives.CACHE_TRANSFERS}")
    c_abs = transformer.abstract_cache(cfg, batch, total)
    abs_l = tree_leaves(c_abs, is_leaf=is_tensor_spec)
    axes_l = [tuple(a) for a in tree_leaves(
        transformer.cache_axes(cfg, batch, total), is_leaf=is_axes)]
    dst_l = tree_leaves(dst_shardings, is_leaf=_is_sharding)
    seq_ix = [la.index("kv_seq") if mode == "int8" and "kv_seq" in la
              else None for la in axes_l]
    kind = f"cache_move_{mode}"
    if not _ranked(dec_mesh):
        return make_cache_transfer_step(cfg, batch, total, mode)
    if src_mesh is None:
        raise ValueError("make_cache_mover across ranks needs src_mesh=, "
                         "the prefill ranks' mesh")
    pre = mesh_ranks(src_mesh)
    dec = mesh_ranks(dec_mesh)
    rank = dist.get_rank()

    def regions(x, si, dst, r):
        """The payload region decode rank ``r`` receives of leaf ``x``,
        and the sequence slice it keeps after dequantizing: under int8
        the whole sequence crosses (its blocks run along it)."""
        reg = _shard_region(x.shape, dst[1], dst[0], r)
        if si is None:
            return reg, None
        return reg[:si] + reg[si + 1:] + (slice(0, x.shape[si]),), reg[si]

    def move(cache):
        sends, recvs = [], []
        if rank in pre:
            j = pre.index(rank)
            for x, si, dst in zip([_full(c) for c in tree_leaves(cache)],
                                  seq_ix, dst_l):
                if si is not None:
                    q, sc = collectives.quantize_int8_seqaxis(x, si)
                for r in dec[j::len(pre)]:
                    reg, _ = regions(x, si, dst, r)
                    sends += [(x[reg], r)] if si is None else \
                        [(q[reg], r), (sc[reg[:-1]], r)]
        if rank in dec:
            src = pre[dec.index(rank) % len(pre)]
            for x, si, dst in zip(abs_l, seq_ix, dst_l):
                reg, _ = regions(x, si, dst, rank)
                shape = tuple(r.stop - r.start for r in reg)
                if si is None:
                    recvs.append((shape, x.dtype, _device(dst), src))
                else:
                    nb = collectives.lastdim_blocks(x.shape[si])[1]
                    recvs += [(shape, torch.int8, _device(dst), src),
                              (shape[:-1] + (nb,), torch.float32,
                               _device(dst), src)]
        got = iter(collectives.exchange(kind, sends, recvs))
        if rank not in dec:
            return None
        out = []
        for x, si, dst in zip(abs_l, seq_ix, dst_l):
            if si is None:
                local = next(got)
            else:
                _, keep = regions(x, si, dst, rank)
                local = collectives.dequantize_int8_seqaxis(
                    next(got), next(got), si).to(x.dtype)
                local = local[(slice(None),) * si + (keep,)]
            out.append(collectives.from_local(local, place=dst[1],
                                              mesh=dst[0], shape=x.shape))
        return tree_unflatten(c_abs, out)

    return move


def _is_sharding(x) -> bool:
    """A ``(mesh, placements)`` leaf of ``sharding.tree_shardings``."""
    return isinstance(x, tuple) and len(x) == 2 and shd.is_device_mesh(x[0])


def _device(dst) -> torch.device:
    mesh = dst[0]
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _default_page(base: int) -> int:
    """Page size when ``page_size=0``: the tuned ``paged_attn`` registry
    point, capped so a row spans at least 8 pages."""
    from repro_torch.kernels.paged_attn import tuned_page_size
    return max(1, min(tuned_page_size(base), -(-base // 8)))


def _check_prompt_lens(cfg, lens: np.ndarray, b: int, s0: int,
                       max_new: int, total: int, paged: bool) -> None:
    """Loud validation of per-request lengths against the prompt buffer
    and the decode horizon: a request longer than the horizon is refused,
    never silently truncated; under ``--paged`` the horizon cap does not
    apply (pages allocate on demand), so the same request admits."""
    lens = np.asarray(lens)
    if lens.shape != (b,):
        raise ValueError(f"prompt_lens shape {tuple(lens.shape)} does not "
                         f"match the batch ({b},)")
    if (lens < 1).any():
        raise ValueError("every request needs at least one prompt token; "
                         f"got prompt_lens={lens.tolist()}")
    over = np.nonzero(lens > s0)[0]
    if over.size:
        i = int(over[0])
        raise ValueError(
            f"request {i} claims {int(lens[i])} prompt tokens but the "
            f"prompt buffer holds only {s0}: the overflow was already "
            f"lost — refusing to serve a silently truncated prompt")
    if paged:
        return
    over = np.nonzero(lens + max_new > total)[0]
    if over.size:
        i = int(over[0])
        raise ValueError(
            f"request {i} needs {int(lens[i]) + max_new} positions "
            f"(prompt {int(lens[i])} + {max_new} new) but the decode "
            f"horizon is {total} for {cfg.name}: refusing to truncate — "
            f"raise --horizon, or serve --paged (pages allocate on "
            f"demand, so long requests admit instead of truncating)")


def _params_device(params) -> torch.device:
    leaf = tree_leaves(params)[0]
    return leaf.to_local().device if shd.is_dtensor(leaf) else leaf.device


def _tokens(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int32), device=dev)


def _wait(tree) -> None:
    """Block until the tensors of ``tree`` are computed: on the card, the
    stream they were enqueued on drains; on the host every op has
    finished when it returns."""
    leaves = tree_leaves(tree)
    if leaves and leaves[0].device.type == "cuda":
        torch.cuda.current_stream(leaves[0].device).synchronize()


def _sample(logits: torch.Tensor, temperature: float,
            gen: torch.Generator) -> np.ndarray:
    """Categorical draws from ``softmax(logits / temperature)`` with the
    Gumbel-max trick, on the host from ``gen``: rows of ``logits``
    (..., V) -> int32 (...)."""
    lg = _full(logits).float().cpu() / temperature
    u = torch.rand(lg.shape, generator=gen).clamp_(min=1e-20)
    return torch.argmax(lg - torch.log(-torch.log(u)), -1).numpy() \
        .astype(np.int32)


def _greedy(logits: torch.Tensor) -> np.ndarray:
    return torch.argmax(_full(logits), -1).to(torch.int32).cpu().numpy()


def _row_generator(seed: int, i: int) -> torch.Generator:
    """Request ``i``'s own stream of draws under ``seed`` (the
    reference's ``fold_in(key, i)``)."""
    state = np.random.SeedSequence([seed, i]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


class _Roles:
    """The prefill and decode sides of one serving run: meshes, rules,
    contexts, this rank's membership, the parameters laid out on each side
    (once per distinct mesh) and the ranks whose tokens the others take.
    """

    def __init__(self, cfg, params, mesh, rules, decode_mesh, decode_rules,
                 act_transport, prefill_meshes=None):
        self.disagg = decode_mesh is not None
        if self.disagg and mesh is None:
            raise ValueError("disaggregated serving (decode_mesh=...) needs "
                             "a prefill mesh too")
        for m in [mesh, decode_mesh] + list(prefill_meshes or []):
            size = 0 if m is None or _ranked(m) else \
                int(np.prod(list(shd.axis_sizes(m).values())))
            if size > 1:
                raise ValueError(
                    f"a one-process mesh of {size} devices: a mesh of more "
                    "than one device is a DeviceMesh over ranks "
                    "(launch.mesh.init_ranks, then make_local_mesh)")
        if mesh is not None and rules is None:
            rules = shd.PRESETS["serve_sp"]
        if self.disagg and decode_rules is None:
            decode_rules = shd.PRESETS["serve_decode"]
        self.cfg, self.params = cfg, params
        self.mesh, self.rules = mesh, rules
        self.pre_meshes = list(prefill_meshes) if prefill_meshes is not None \
            else [mesh]
        self.dec_mesh = decode_mesh if self.disagg else mesh
        self.dec_rules = decode_rules if self.disagg else rules
        # under the serve_decode preset the cache is resident: decode has
        # no per-step gather to compress, so the decode half runs bf16
        self.dec_act = "bf16" if self.disagg \
            and self.dec_rules is shd.PRESETS["serve_decode"] \
            else act_transport
        self.dec_in = _member(self.dec_mesh)
        self.dec_src = _source(self.dec_mesh)
        self.dev = _params_device(params)
        self._placed = {}

    def params_on(self, mesh, rules):
        """The parameters laid out on ``mesh`` (placed once per mesh)."""
        if id(mesh) not in self._placed:
            self._placed[id(mesh)] = _place(
                self.params, transformer.param_axes(self.cfg), mesh, rules)
        return self._placed[id(mesh)]

    def pre(self, w: int = 0):
        m = self.pre_meshes[w]
        return m, _member(m), _source(m), _context(m, self.rules)

    def dec_ctx(self):
        return _context(self.dec_mesh, self.dec_rules)

    def params_dec(self):
        return self.params_on(self.dec_mesh, self.dec_rules)

    def moves(self, w: int = 0) -> bool:
        """Whether worker ``w``'s caches cross to other ranks."""
        return self.disagg or (_ranked(self.dec_mesh)
                               and self.pre_meshes[w] is not self.dec_mesh)

    def mover(self, batch: int, width: int, transfer: str, w: int = 0):
        abs_w = transformer.abstract_cache(self.cfg, batch, width)
        dst = shd.tree_shardings(abs_w, transformer.cache_axes(
            self.cfg, batch, width), self.dec_mesh, self.dec_rules) \
            if _ranked(self.dec_mesh) else None
        return make_cache_mover(self.cfg, batch, width, self.dec_mesh,
                                self.dec_rules, transfer, dst,
                                src_mesh=self.pre_meshes[w])

    def store_state(self, store):
        """``store``'s zero state table laid out on the decode mesh."""
        if not self.dec_in:
            return None
        return _place(store.init_state(self.dev), store.state_axes(),
                      self.dec_mesh, self.dec_rules)


@torch.no_grad()
def generate(cfg, params, prompts: np.ndarray, max_new: int = 16,
             temperature: float = 0.0, seed: int = 0,
             prompt_lens: Optional[np.ndarray] = None,
             mesh=None, rules=None, act_transport: str = "bf16",
             decode_mesh=None, decode_rules=None,
             cache_transfer: str = "bf16", kv_storage: str = "bf16",
             stream: str = "batch", slots: int = 0,
             workers: int = 1, evict: str = "oldest", paged: bool = False,
             page_size: int = 0, pool_pages: int = 0, horizon: int = 0,
             priorities: Optional[np.ndarray] = None, prefill_meshes=None):
    """prompts: (B, S0) int32, right-padded when ragged. Greedy (or
    sampled) decode of ``max_new`` tokens per row; returns (B, max_new)
    int32 on every rank.

    ``prompt_lens`` (B,) enables ragged continuous batching: row i's real
    prompt is ``prompts[i, :prompt_lens[i]]``; every row decodes from its
    own position and pad slots are masked. ``mesh`` (a ``DeviceMesh``, or
    the one-process mesh) places parameters, cache and batch (``rules``
    default to ``serve_sp``); ``act_transport`` picks the activation
    gather's wire format. Across ranks every rank calls ``generate`` with
    the same arguments and the full parameters, and keeps its shards.

    ``decode_mesh`` disaggregates: prefill on ``mesh`` (``rules``), decode
    on ``decode_mesh`` (``decode_rules``, default ``serve_decode``), the
    prefilled cache moved between them by :func:`make_cache_mover`, bf16
    or as seq-blockwise s8 chunks and scales (``cache_transfer``).
    ``kv_storage`` picks the decode-resident cache dtype.

    ``stream="slots"`` streams each request into a running decode batch
    (:func:`_generate_slots`); ``workers > 1``, ``paged=True`` or
    ``prefill_meshes`` route through the fan-in engine
    (:func:`_generate_fanin`). ``horizon`` caps the decode horizon in
    positions (0 = sized to fit).
    """
    if stream not in STREAMS:
        raise ValueError(f"unknown stream {stream!r}; "
                         f"expected one of {STREAMS}")
    if workers > 1 or paged or prefill_meshes is not None:
        return _generate_fanin(
            cfg, params, prompts, max_new=max_new, temperature=temperature,
            prompt_lens=prompt_lens, mesh=mesh, rules=rules,
            act_transport=act_transport, decode_mesh=decode_mesh,
            decode_rules=decode_rules, cache_transfer=cache_transfer,
            kv_storage=kv_storage, slots=slots, workers=workers,
            evict=evict, paged=paged, page_size=page_size,
            pool_pages=pool_pages, horizon=horizon, priorities=priorities,
            prefill_meshes=prefill_meshes)
    if stream == "slots":
        return _generate_slots(
            cfg, params, prompts, max_new=max_new, temperature=temperature,
            seed=seed, prompt_lens=prompt_lens, mesh=mesh, rules=rules,
            act_transport=act_transport, decode_mesh=decode_mesh,
            decode_rules=decode_rules, cache_transfer=cache_transfer,
            kv_storage=kv_storage, slots=slots, horizon=horizon)
    b, s0 = prompts.shape
    total = s0 + max_new
    ragged = prompt_lens is not None
    lens = np.asarray(prompt_lens, np.int32) if ragged else None
    _check_prompt_lens(cfg, lens if ragged else np.full((b,), s0, np.int32),
                       b, s0, max_new, int(horizon) or total, paged=False)
    if ragged:
        # ragged masking is sound only for full (slot == position) caches:
        # ring buffers alias a pad's junk slot into the window and
        # recurrent states scan pad tokens in
        registry.require(cfg, "ragged", "ragged prompt_lens")
    if cache_transfer not in collectives.CACHE_TRANSFERS:
        raise ValueError(f"unknown cache_transfer {cache_transfer!r}; "
                         f"expected one of {collectives.CACHE_TRANSFERS}")
    roles = _Roles(cfg, params, mesh, rules, decode_mesh, decode_rules,
                   act_transport)
    dev = roles.dev
    prefill = step_lib.make_prefill_step(cfg, act_transport)
    # validates kv_storage (and the family's eligibility for it)
    decode = step_lib.make_decode_step(cfg, total, roles.dec_act, kv_storage)
    c_abs = transformer.abstract_cache(cfg, b, total)
    c_axes = transformer.cache_axes(cfg, b, total)

    pre_mesh, pre_in, pre_src, pre_ctx = roles.pre()
    cache, tok = None, np.zeros((b,), np.int32)
    if pre_in:
        with pre_ctx:
            pre_batch = {"tokens": _tokens(prompts, dev)}
            if ragged:
                pre_batch["last_pos"] = _tokens(lens - 1, dev)
            logits, cache = prefill(roles.params_on(pre_mesh, roles.rules),
                                    pre_batch)
            cache = grow_cache(cache, c_abs)
            tok = _greedy(logits)
    # the first token comes from the prefill logits: the one batch tensor
    # that crosses from the prefill to the decode side
    tok = _share(tok, pre_src)

    # ---- handoff: the grown cache onto the decode side
    with roles.dec_ctx():
        if roles.moves():
            cache = roles.mover(b, total, cache_transfer)(cache)
        if roles.dec_in:
            cache = _commit(cache, c_axes)
            cache = _commit(transformer.quantize_cache(cache, kv_storage),
                            transformer.cache_axes(cfg, b, total,
                                                   kv_storage=kv_storage))
            params_dec = roles.params_dec()

        gen = torch.Generator().manual_seed(seed)
        out_tokens = []
        for i in range(max_new):
            out_tokens.append(tok[:, None])
            nxt = np.zeros((b,), np.int32)
            if roles.dec_in:
                pos = _tokens(lens + i, dev) if ragged \
                    else _tokens(s0 + i, dev)
                logits, cache = decode(params_dec, cache, {
                    "tokens": _tokens(tok[:, None], dev), "pos": pos})
                nxt = _sample(logits, temperature, gen) if temperature > 0 \
                    else _greedy(logits)
            tok = _share(nxt, roles.dec_src)
    return np.concatenate(out_tokens, axis=1)


def supports_slot_streaming(cfg) -> bool:
    """Every family serves through slot streaming: attention caches admit
    as ``[1, total]`` cache slices, ring-buffer and recurrent
    (``row_state``) families admit their O(1) per-row state as a
    whole-row overwrite after an exact-length prefill."""
    return registry.capabilities(cfg).slot_stream


def _require_slot_streaming(cfg) -> None:
    registry.require(cfg, "slot_stream", "--stream slots")


def make_slot_admit_step(cfg, slots: int, total: int, transfer: str,
                         kv_storage: str,
                         block: int = collectives.ACT_BLOCK):
    """Admission step of continuous slot streaming: returns
    ``admit(cache, slice, slot) -> cache``, a thin wrapper over
    :meth:`repro_torch.models.registry.StateStore.admit_row` writing one
    request's grown ``[1, total]`` bf16 state slice into row ``slot`` of
    the running decode state table (in its resident layout).
    ``transfer="int8"`` moves each sequence-carrying leaf through
    ``collectives.stream_slot_int8`` and each O(1) row-state leaf through
    ``collectives.stream_row_int8``: s8 chunks and scales on the wire
    when the slice's layout differs from the table row's. The two-mesh
    path ships the slice with :func:`make_cache_mover` before admission
    and calls this with ``transfer="bf16"``."""
    if transfer not in collectives.CACHE_TRANSFERS:
        raise ValueError(f"unknown cache_transfer {transfer!r}; "
                         f"expected one of {collectives.CACHE_TRANSFERS}")
    _require_slot_streaming(cfg)
    store = registry.state_store(cfg, slots, total, kv_storage=kv_storage)

    @torch.no_grad()
    def admit(cache, slc, slot):
        return store.admit_row(cache, slc, slot, transfer=transfer,
                               block=block)
    return admit


def _step_mode(dec_mesh, dev: torch.device) -> str:
    """How the slot engine runs its decode step: ``"rebind"`` on ranks,
    where the step's collectives and DTensors stay eager; else
    ``"graph"`` on a CUDA device and ``"static"`` elsewhere."""
    if _ranked(dec_mesh):
        return "rebind"
    return "graph" if dev.type == "cuda" else "static"


class _SlotStep:
    """The slot engine's decode step over its slot table.

    ``mode`` is :func:`_step_mode`'s. Under ``"rebind"`` each step
    builds its inputs and rebinds the table to the cache ``decode``
    returns. Otherwise the table stays where it was allocated: each step
    writes the slots' tokens and positions into a buffer of its own, runs
    ``decode`` and copies every leaf of the returned cache back into the
    table, and so does admission. Under ``"graph"`` the second step
    records the first's kernels as one ``torch.cuda.CUDAGraph`` (the
    first is the warm-up capture asks for) and every step from the
    second on replays it; the graph and its memory pool go with this
    object. A step returns the logits, which the graph's replays
    overwrite.
    """

    def __init__(self, decode, params, cache, n_slots: int, dev, mode: str):
        self.decode, self.params, self.cache = decode, params, cache
        self.dev, self.mode = dev, mode
        # the tokens and positions, one copy from the host a step
        self.inputs = torch.zeros((2, n_slots), dtype=torch.int32,
                                  device=dev)
        self.batch = {"tokens": self.inputs[0, :, None],
                      "pos": self.inputs[1]}
        self.cuda_graph = self.logits = None
        self.steps = self.replays = 0

    def _copy_back(self, new) -> None:
        for c, n in zip(tree_leaves(self.cache), tree_leaves(new)):
            if n is not c:
                c.copy_(n)

    def _run(self):
        logits, new = self.decode(self.params, self.cache, self.batch)
        self._copy_back(new)
        return logits

    def _capture(self) -> None:
        g = torch.cuda.CUDAGraph()
        with obs.span("serve.graph.capture"), torch.cuda.graph(g):
            self.logits = self._run()
        obs.count("serve.graph.captures")
        self.cuda_graph = g

    def __call__(self, tok: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        self.steps += 1
        if self.mode == "rebind":
            logits, self.cache = self.decode(self.params, self.cache, {
                "tokens": _tokens(tok[:, None], self.dev),
                "pos": _tokens(pos, self.dev)})
            return logits
        self.inputs.copy_(torch.from_numpy(np.stack([tok, pos])))
        if self.mode == "graph" and self.cuda_graph is None \
                and self.steps > 1:
            self._capture()
        if self.cuda_graph is None:
            return self._run()
        self.cuda_graph.replay()
        self.replays += 1
        obs.count("serve.graph.replays")
        return self.logits

    def admit(self, admit, slc, slot: int) -> None:
        """Admit ``slc`` into row ``slot`` through ``admit``."""
        new = admit(self.cache, slc, slot)
        if self.mode == "rebind":
            self.cache = new
        else:
            self._copy_back(new)


def _generate_slots(cfg, params, prompts: np.ndarray, max_new: int,
                    temperature: float, seed: int,
                    prompt_lens: Optional[np.ndarray],
                    mesh, rules, act_transport: str,
                    decode_mesh, decode_rules,
                    cache_transfer: str, kv_storage: str, slots: int,
                    horizon: int = 0):
    """Continuous slot streaming: each request is prefilled on its own and
    its cache slice admitted into a free row of a RUNNING decode batch.

    The decode side holds a slot table of ``slots`` rows. Each request is
    prefilled alone -- ``[1, S0]`` with a last position for dense caches,
    ``[1, len_i]`` exact-length for ``row_state`` families -- its grown
    slice moved to the decode mesh (:func:`make_cache_mover`, with a
    ``decode_mesh``) and admitted into a free slot
    (:func:`make_slot_admit_step`), and the slot decodes from the
    request's own position while other slots are mid-decode or empty. A
    finished slot is freed and reused by the next pending request;
    admission overwrites the whole row. The next pending request's
    prefill and shipment are issued at admission time, before the decode
    steps that follow (the reference's double buffer).

    The decode step is a :class:`_SlotStep`. Where one process decodes on
    a CUDA device, the call's first step runs eagerly and every later one
    replays a CUDA graph of it, captured at the second step and freed
    when the call returns; nothing outlives the call.

    ``_generate_slots.last_stats`` holds ``admissions``,
    ``decode_steps``, ``graph_steps`` (the steps that replayed the graph)
    and ``transfer_wait_s``: the host's wait, at admission, for the
    shipment's tensors to be ready. The prefill was enqueued on the same
    stream as the decode steps since, whose own syncs have usually
    retired it, so on the card the wait is near zero; on the host it is
    zero.

    Recorded by :mod:`repro_torch.obs` when on: per request ``serve.queue``
    (from the call's start to its admission), ``serve.prefill`` and
    ``serve.admit`` (the wait and ``admit_row``); per decode step
    ``serve.step``, with children ``serve.step.launch`` (the inputs and
    ``decode``, or the graph's replay) and ``serve.step.wait`` (the
    token's pick and copy to the host); the step's time outside them is
    the slot table's bookkeeping. The capture is a ``serve.graph.capture``
    span, and the counters ``serve.graph.captures`` and
    ``serve.graph.replays`` count captures and replays.
    """
    t_call = obs.now()
    b, s0 = prompts.shape
    total = int(horizon) if horizon else s0 + max_new
    lens = np.asarray(prompt_lens, np.int32) if prompt_lens is not None \
        else np.full((b,), s0, np.int32)
    _check_prompt_lens(cfg, lens, b, s0, max_new, total, paged=False)
    _require_slot_streaming(cfg)
    caps = registry.capabilities(cfg)
    if cache_transfer not in collectives.CACHE_TRANSFERS:
        raise ValueError(f"unknown cache_transfer {cache_transfer!r}; "
                         f"expected one of {collectives.CACHE_TRANSFERS}")
    n_slots = int(slots) if slots else b
    if n_slots < 1:
        raise ValueError(f"slot table needs at least one slot, got {slots}")
    roles = _Roles(cfg, params, mesh, rules, decode_mesh, decode_rules,
                   act_transport)
    dev = roles.dev
    pre_mesh, pre_in, pre_src, pre_ctx = roles.pre()

    prefill = step_lib.make_prefill_step(cfg, act_transport)
    decode = step_lib.make_decode_step(cfg, total, roles.dec_act, kv_storage)
    slice_abs = transformer.abstract_cache(cfg, 1, total)
    mover = roles.mover(1, total, cache_transfer) if roles.moves() else None
    admit = make_slot_admit_step(
        cfg, n_slots, total, "bf16" if mover is not None else cache_transfer,
        kv_storage)
    cache = roles.store_state(registry.state_store(
        cfg, n_slots, total, kv_storage=kv_storage))
    step = _SlotStep(decode, roles.params_dec(), cache, n_slots, dev,
                     _step_mode(roles.dec_mesh, dev)) if roles.dec_in else None

    # ---- host-side slot table + the prefetched shipment ----------------
    out_tokens = [[] for _ in range(b)]
    slot_req = [-1] * n_slots          # request id per slot, -1 = free
    slot_tok = np.zeros((n_slots,), np.int32)
    slot_pos = np.zeros((n_slots,), np.int32)
    slot_gen: list = [None] * n_slots
    next_req = 0
    inflight: list = []                # at most one prefetched shipment
    stats = {"admissions": 0, "transfer_wait_s": 0.0, "decode_steps": 0,
             "graph_steps": 0}

    def start_prefetch():
        """Prefill the next pending request, grow its slice and ship it."""
        nonlocal next_req
        if next_req >= b or inflight:
            return
        i = next_req
        next_req += 1
        slc, tok0 = None, np.zeros((1,), np.int32)
        if pre_in:
            with pre_ctx, obs.span("serve.prefill", req=i):
                p = roles.params_on(pre_mesh, roles.rules)
                if caps.row_state:
                    # ring-buffer / recurrent state: pad tokens must never
                    # enter the per-row state, so the request is
                    # prefilled at its length
                    logits, c = prefill(p, {
                        "tokens": _tokens(prompts[i:i + 1, :lens[i]], dev)})
                else:
                    logits, c = prefill(p, {
                        "tokens": _tokens(prompts[i:i + 1], dev),
                        "last_pos": _tokens(lens[i:i + 1] - 1, dev)})
                slc = grow_cache(c, slice_abs)
                tok0 = _greedy(logits)
        tok0 = _share(tok0, pre_src)
        if mover is not None:
            with roles.dec_ctx():
                slc = mover(slc)
        inflight.append((i, slc, tok0))

    def emit(i, t, slot):
        out_tokens[i].append(int(t))
        if len(out_tokens[i]) >= max_new:
            slot_req[slot] = -1        # free the slot for reuse

    def admit_next(slot):
        if not inflight:
            start_prefetch()
        i, slc, tok0 = inflight.pop(0)
        if roles.dec_in:
            t0 = obs.now()
            _wait(slc)
            stats["transfer_wait_s"] += (obs.now() - t0) * 1e-9
            with roles.dec_ctx():
                step.admit(admit, slc, slot)
            obs.record("serve.admit", t0, obs.now(), req=i)
        stats["admissions"] += 1
        slot_req[slot] = i
        slot_pos[slot] = lens[i]
        slot_tok[slot] = int(tok0[0])
        slot_gen[slot] = _row_generator(seed, i)
        emit(i, slot_tok[slot], slot)  # the prefill token
        obs.record("serve.queue", t_call, obs.now(), req=i)
        start_prefetch()               # the next shipment, ahead of decode

    start_prefetch()
    while True:
        # keep admitting until the table is full or the queue drains: a
        # slot freed at admission (max_new == 1) is refilled in this pass
        admitted = True
        while admitted:
            admitted = False
            for s_ in range(n_slots):
                if slot_req[s_] < 0 and (inflight or next_req < b):
                    admit_next(s_)
                    admitted = True
        if all(r < 0 for r in slot_req):
            break                      # nothing active, nothing pending
        with obs.span("serve.step"):
            nxt = np.zeros((n_slots,), np.int32)
            if roles.dec_in:
                with obs.span("serve.step.launch"), roles.dec_ctx():
                    logits = step(slot_tok, slot_pos)
                with obs.span("serve.step.wait"):
                    if temperature > 0:
                        for s_ in range(n_slots):
                            if slot_req[s_] >= 0:
                                nxt[s_] = _sample(_full(logits)[s_],
                                                  temperature, slot_gen[s_])
                    else:
                        nxt = _greedy(logits)
            nxt = _share(nxt, roles.dec_src)
            stats["decode_steps"] += 1
            for s_ in range(n_slots):
                i = slot_req[s_]
                if i < 0:
                    continue
                slot_tok[s_] = nxt[s_]
                slot_pos[s_] += 1
                emit(i, nxt[s_], s_)

    assert all(len(ts) == max_new for ts in out_tokens)
    if step is not None:
        stats["graph_steps"] = step.replays
    _generate_slots.last_stats = stats     # launcher reporting hook
    return np.asarray(out_tokens, np.int32)


def _generate_fanin(cfg, params, prompts: np.ndarray, max_new: int,
                    temperature: float, prompt_lens: Optional[np.ndarray],
                    mesh, rules, act_transport: str,
                    decode_mesh, decode_rules,
                    cache_transfer: str, kv_storage: str, slots: int,
                    workers: int, evict: str, paged: bool, page_size: int,
                    pool_pages: int, horizon: int,
                    priorities: Optional[np.ndarray], prefill_meshes):
    """Multi-prefill-worker fan-in with slot preemption and an optional
    paged slot cache.

    ``workers`` prefill workers, on their own meshes when
    ``prefill_meshes`` gives one per worker, feed ONE decode slot table.
    Admission order is owned by
    :class:`repro_torch.dist.fanin.AdmissionArbiter` (FIFO with priority
    classes, aging + hard promotion, per-worker in-flight accounting);
    the engine admits the arbiter's chosen shipment, never whichever
    finished first. A worker's ranks prefill its requests, in the order
    the arbiter assigns them, and ship each slice to the decode mesh
    (:func:`make_cache_mover`); the parameters are placed once per
    distinct mesh.

    Preemption is recompute-style: when the table is full and the pending
    request outranks a victim (or has hit the hard promotion bound), the
    victim's slot is freed and the victim requeues with its emitted tokens
    appended to its prompt and ``max_new`` reduced by them. Readmission
    prefills the extended prompt at its exact length, so the greedy
    continuation equals an uncontended run.

    ``paged=True`` stores the slot table as a
    :class:`repro_torch.models.registry.PagedStateStore`: admission ships
    only the pages covering the request's live positions, a page is
    allocated on the host whenever a slot decodes across a page boundary,
    and each decode step runs the unchanged dense step between the
    store's gather and scatter through the page table. The horizon grows
    to the next page multiple that fits the longest request.

    ``_generate_fanin.last_stats`` holds the reference's counters;
    ``transfer_wait_s`` is the host's wait for the arbiter's chosen
    shipment (see :func:`_generate_slots`). Greedy only.
    """
    if temperature > 0:
        raise ValueError(
            "fan-in serving is greedy-only: an evicted request re-prefills "
            "its emitted tokens on readmission, and a sampled continuation "
            "across that recompute is not replayable; use temperature=0 "
            "(the single-worker paths support sampling)")
    if evict not in fanin.EVICTION_POLICIES:
        raise ValueError(f"unknown eviction policy {evict!r}; "
                         f"expected one of {fanin.EVICTION_POLICIES}")
    if workers < 1:
        raise ValueError(f"need at least one prefill worker, got {workers}")
    if cache_transfer not in collectives.CACHE_TRANSFERS:
        raise ValueError(f"unknown cache_transfer {cache_transfer!r}; "
                         f"expected one of {collectives.CACHE_TRANSFERS}")
    b, s0 = prompts.shape
    lens = np.asarray(prompt_lens, np.int32) if prompt_lens is not None \
        else np.full((b,), s0, np.int32)
    _require_slot_streaming(cfg)
    caps = registry.capabilities(cfg)
    prios = np.zeros((b,), np.int32) if priorities is None \
        else np.asarray(priorities, np.int32)
    if prios.shape != (b,):
        raise ValueError(f"priorities shape {tuple(prios.shape)} does not "
                         f"match the batch ({b},)")
    classes = int(prios.max()) + 1 if b else 1
    n_slots = int(slots) if slots else b
    if n_slots < 1:
        raise ValueError(f"slot table needs at least one slot, got {slots}")

    # ---- horizon / page sizing -----------------------------------------
    if paged:
        # the horizon never caps a paged table: it grows to the longest
        # request
        base = max(int(horizon), int((lens + max_new).max()))
        P = int(page_size) or _default_page(base)
        if P < 1:
            raise ValueError(f"page size must be >= 1, got {P}")
        total = -(-base // P) * P        # next page multiple that fits
        _check_prompt_lens(cfg, lens, b, s0, max_new, total, paged=True)
    else:
        P = 0
        total = int(horizon) if horizon else s0 + max_new
        _check_prompt_lens(cfg, lens, b, s0, max_new, total, paged=False)

    if prefill_meshes is not None:
        prefill_meshes = list(prefill_meshes)
        if len(prefill_meshes) != workers:
            raise ValueError(
                f"{len(prefill_meshes)} prefill meshes for {workers} "
                f"workers: fan-in needs one mesh per worker (or none)")
        if mesh is None:
            mesh = prefill_meshes[0]
    else:
        prefill_meshes = [mesh] * workers
    roles = _Roles(cfg, params, mesh, rules, decode_mesh, decode_rules,
                   act_transport, prefill_meshes)
    dev = roles.dev

    prefill = step_lib.make_prefill_step(cfg, act_transport)
    decode_fn = step_lib.make_decode_step(cfg, total, roles.dec_act,
                                          kv_storage)
    fit_abs, movers = {}, {}

    def fit(c, width):
        if width not in fit_abs:
            fit_abs[width] = transformer.abstract_cache(cfg, 1, width)
        return fit_cache(c, fit_abs[width])

    def mover(w, width):
        key = (id(prefill_meshes[w]), width)
        if key not in movers:
            # colocated workers on meshes of their own ship raw; the
            # admission then applies the transfer as on one mesh
            movers[key] = roles.mover(
                1, width, cache_transfer if roles.disagg else "bf16", w)
        return movers[key]

    # ---- decode-side programs: slot table (dense or paged) --------------
    admit_transfer = "bf16" if roles.disagg else cache_transfer
    if paged:
        store = registry.paged_state_store(
            cfg, n_slots, total, kv_storage=kv_storage, page=P,
            pool_pages=int(pool_pages))

        @torch.no_grad()
        def admit(cache, slc, page_idx):
            return store.admit_pages(cache, slc, page_idx,
                                     transfer=admit_transfer)

        @torch.no_grad()
        def decode(p, pool, pt, batch):
            dense = store.gather_dense(pool, pt)
            logits, dense = decode_fn(p, dense, batch)
            return logits, store.scatter_dense(pool, dense, pt)
    else:
        store = registry.state_store(cfg, n_slots, total,
                                     kv_storage=kv_storage)
        admit = make_slot_admit_step(cfg, n_slots, total, admit_transfer,
                                     kv_storage)
        decode = decode_fn
    cache = roles.store_state(store)

    # ---- host state: queue, slot table, page table ----------------------
    arb = fanin.AdmissionArbiter(workers=workers, classes=classes)
    base_prompts = [np.asarray(prompts[i, :lens[i]], np.int32).copy()
                    for i in range(b)]
    for i in range(b):
        arb.submit(fanin.Request(rid=i, prompt=base_prompts[i],
                                 max_new=int(max_new),
                                 priority=int(prios[i])))
    out_tokens = [[] for _ in range(b)]
    remaining = np.full((b,), max_new, np.int64)
    slot_occ: list = [None] * n_slots           # fanin.Occupant or None
    slot_reqobj: list = [None] * n_slots        # fanin.Request or None
    slot_tok = np.zeros((n_slots,), np.int32)
    slot_pos = np.zeros((n_slots,), np.int32)
    shipments = {}                              # rid -> (slc, tok0, length)
    pt = store.init_page_table() if paged else None
    free_pages = deque(range(store.n_pool)) if paged else None
    stats = {"admissions": 0, "evictions": 0, "requeues": 0,
             "decode_steps": 0, "transfer_wait_s": 0.0,
             "max_wait_passes": 0, "peak_live_pages": 0}

    def alloc_page() -> int:
        if not free_pages:
            raise RuntimeError(
                f"paged pool exhausted: all {store.n_pool} pages of the "
                f"{n_slots}-slot table are live; raise --pool-pages "
                f"(0 = fully backed: slots x pages-per-row = "
                f"{n_slots * store.pages_per_row}) or lower --slots")
        p = free_pages.popleft()
        stats["peak_live_pages"] = max(stats["peak_live_pages"],
                                       store.n_pool - len(free_pages))
        return p

    def free_row(s):
        if paged:
            for pg in np.nonzero(pt[s] >= 0)[0]:
                free_pages.append(int(pt[s, pg]))
            pt[s, :] = -1
        slot_occ[s] = None
        slot_reqobj[s] = None

    def ensure_page(s, pos):
        """Allocate the page holding ``pos`` before the slot writes it."""
        pg = pos // P
        if pg >= store.pages_per_row:
            raise RuntimeError(
                f"slot {s} at position {pos} is past the {total}-position "
                f"paged horizon — engine accounting bug")
        if pt[s, pg] < 0:
            pt[s, pg] = alloc_page()

    def dispatch(req):
        """Prefill one assigned request on its worker's ranks, fit its
        slice and ship it to the decode side."""
        plen = int(req.prompt.shape[0])
        w = req.worker
        pre_mesh, pre_in, pre_src, pre_ctx = roles.pre(w)
        width = -(-plen // P) * P if paged else total
        slc, tok0 = None, np.zeros((1,), np.int32)
        if pre_in:
            with pre_ctx:
                p = roles.params_on(pre_mesh, roles.rules)
                if req.evictions == 0 and not caps.row_state and plen <= s0:
                    # fresh admission: padded [1, S0] prefill with a last
                    # position
                    toks = np.zeros((1, s0), np.int32)
                    toks[0, :plen] = req.prompt
                    logits, c = prefill(p, {
                        "tokens": _tokens(toks, dev),
                        "last_pos": _tokens([plen - 1], dev)})
                else:
                    # readmission (or row_state): exact-length prefill of
                    # the extended prompt
                    logits, c = prefill(p, {
                        "tokens": _tokens(req.prompt[None, :], dev)})
                slc = fit(c, width)
                tok0 = _greedy(logits)
        tok0 = _share(tok0, pre_src)
        if roles.moves(w):
            with roles.dec_ctx():
                slc = mover(w, width)(slc)
        shipments[req.rid] = (slc, tok0, plen)

    def emit(i, t, s):
        out_tokens[i].append(int(t))
        remaining[i] -= 1
        if remaining[i] <= 0:
            free_row(s)

    def evict_slot(s):
        req = slot_reqobj[s]
        arb.evicted(req)
        # recompute preemption: requeue with the emitted tokens appended,
        # budget reduced by them; aging restarts for the new occupancy
        req.prompt = np.concatenate(
            [base_prompts[req.rid],
             np.asarray(out_tokens[req.rid], np.int32)])
        req.max_new = int(remaining[req.rid])
        free_row(s)
        arb.submit(req, requeue=True)
        stats["evictions"] += 1
        stats["requeues"] += 1

    def admit_into(s, req):
        nonlocal cache
        slc, tok0, plen = shipments.pop(req.rid)
        if roles.dec_in:
            t0 = time.perf_counter()
            _wait(slc)               # the arbiter's choice, NOT first-done
            stats["transfer_wait_s"] += time.perf_counter() - t0
        occ = arb.admit(req)
        stats["max_wait_passes"] = max(stats["max_wait_passes"], req.skips)
        if paged:
            n_ship = -(-plen // P)
            idx = np.asarray([alloc_page() for _ in range(n_ship)], np.int32)
            pt[s, :n_ship] = idx
        if roles.dec_in:
            with roles.dec_ctx():
                cache = admit(cache, slc, idx if paged else s)
        stats["admissions"] += 1
        slot_occ[s] = occ
        slot_reqobj[s] = req
        slot_pos[s] = plen
        slot_tok[s] = int(tok0[0])
        emit(req.rid, slot_tok[s], s)           # the prefill token

    def try_admissions():
        while True:
            req = arb.next_admission()
            if req is None:
                return
            s = next((i for i in range(n_slots) if slot_occ[i] is None),
                     None)
            if s is None:
                s = arb.pick_victim(slot_occ, evict, req)
                if s is None:
                    return              # no justified victim: age in queue
                evict_slot(s)
            admit_into(s, req)

    # ---- main loop: assign -> admit -> age -> decode --------------------
    passes = 0
    limit = 1000 + 20 * b * (max_new + n_slots + arb.promotion_cycles)
    while True:
        passes += 1
        if passes > limit:
            raise RuntimeError(
                f"fan-in engine made no progress in {limit} passes "
                f"(queue={len(arb.queue)}, "
                f"occupied={sum(o is not None for o in slot_occ)})")
        for req in arb.assign():
            dispatch(req)
        try_admissions()
        arb.age()
        if all(o is None for o in slot_occ):
            if not arb.queue:
                break
            continue
        if paged:
            for s in range(n_slots):
                if slot_occ[s] is not None:
                    ensure_page(s, int(slot_pos[s]))
        nxt = np.zeros((n_slots,), np.int32)
        if roles.dec_in:
            batch = {"tokens": _tokens(slot_tok[:, None], dev),
                     "pos": _tokens(slot_pos, dev)}
            with roles.dec_ctx():
                if paged:
                    logits, cache = decode(roles.params_dec(), cache, pt,
                                           batch)
                else:
                    logits, cache = decode(roles.params_dec(), cache, batch)
            nxt = _greedy(logits)
        nxt = _share(nxt, roles.dec_src)
        stats["decode_steps"] += 1
        for s in range(n_slots):
            if slot_occ[s] is None:
                continue
            slot_tok[s] = int(nxt[s])
            slot_pos[s] += 1
            emit(slot_reqobj[s].rid, int(nxt[s]), s)

    bad = [i for i in range(b) if len(out_tokens[i]) != max_new]
    if bad:
        raise RuntimeError(f"fan-in engine dropped requests {bad}: "
                           f"emitted {[len(out_tokens[i]) for i in bad]} "
                           f"of {max_new} tokens")
    if paged:
        stats["page"] = P
        stats["hbm_bytes_per_slot"] = (stats["peak_live_pages"]
                                       * store.page_bytes()) // n_slots
        dense = sum(l.nbytes for l in store.dense_abstract_state().values())
        stats["dense_hbm_bytes_per_slot"] = dense // n_slots
    _generate_fanin.last_stats = stats          # launcher reporting hook
    return np.asarray(out_tokens, np.int32)


def _pick_tp(n_devices: int, cfg) -> int:
    """Largest model-parallel degree (<= 2) the rank count and head
    counts admit -- the smoke default; override with --tp."""
    for tp in (2, 1):
        if n_devices % tp == 0 and cfg.n_heads % tp == 0:
            return tp
    return 1


def _rank_mesh(ranks, tp: int, device_type: str):
    """A ``(data, model)`` ``DeviceMesh`` over ``ranks``, ``tp`` wide. Every
    rank of the world must build every such mesh, in the same order: its
    process groups are made collectively."""
    from torch.distributed.device_mesh import DeviceMesh

    arr = torch.tensor(list(ranks), dtype=torch.int64).reshape(
        len(ranks) // tp, tp)
    return DeviceMesh(device_type, arr, mesh_dim_names=("data", "model"))


def _split_world(device):
    """(prefill ranks, decode ranks, world size, device type): the first
    half of the world prefills, the second half decodes; one rank (or one
    process) serves both."""
    dev = resolve_device(device, "make_disagg_meshes")
    n = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(n))
    pre, dec = (ranks[:n // 2], ranks[n // 2:]) if n >= 2 else (ranks, ranks)
    return pre, dec, n, dev.type


def make_disagg_meshes(cfg, tp_prefill: int = 0, tp_decode: int = 0,
                       device=None):
    """Split the world's ranks into a prefill mesh and a decode mesh.

    With >= 2 ranks the halves are disjoint: the cache handoff is a real
    transfer between ranks. One process (no process group) gets the
    one-process ``(1, 1)`` mesh for both roles, and a world of one rank a
    ``(1, 1)`` ``DeviceMesh`` shared by both, so the path runs anywhere.
    Each half keeps a ``(data, model)`` layout; ``tp_*=0`` picks the model
    degree per half. ``device`` names the ranks' device type (the card by
    default).
    """
    pre, dec, n, dtype = _split_world(device)
    if not dist.is_initialized():
        m = make_local_mesh(device=device)
        return m, m

    def mk(ranks, tp):
        tp = tp or _pick_tp(len(ranks), cfg)
        if len(ranks) % tp != 0:
            raise ValueError(
                f"model-parallel degree {tp} does not divide the "
                f"{len(ranks)}-rank mesh half: disaggregated serving gives "
                f"each role {len(ranks)} of the {n} ranks, so --tp must "
                f"divide that")
        return _rank_mesh(ranks, tp, dtype)
    pre_mesh = mk(pre, tp_prefill)
    return pre_mesh, (pre_mesh if dec == pre else mk(dec, tp_decode))


def make_fanin_meshes(cfg, workers: int, tp_prefill: int = 0,
                      tp_decode: int = 0, device=None):
    """Split the world's ranks into ``workers`` prefill-worker meshes plus
    one decode mesh.

    The decode half mirrors :func:`make_disagg_meshes`; the prefill half
    is divided evenly among the workers (each its own ``(data, model)``
    mesh) when its rank count allows, and shared by every worker otherwise
    (the workers are then lanes on one mesh). Returns ``(prefill_meshes,
    decode_mesh)`` with ``len(prefill_meshes) == workers``.
    """
    if workers < 1:
        raise ValueError(f"need at least one prefill worker, got {workers}")
    pre, dec, n, dtype = _split_world(device)
    if not dist.is_initialized():
        m = make_local_mesh(device=device)
        return [m] * workers, m
    if len(pre) >= workers and len(pre) % workers == 0:
        chunk = len(pre) // workers
        groups = [pre[w * chunk:(w + 1) * chunk] for w in range(workers)]
    else:
        groups = [list(pre)] * workers

    built = {}

    def mk(ranks, tp):
        tp = tp or _pick_tp(len(ranks), cfg)
        if len(ranks) % tp != 0:
            raise ValueError(
                f"model-parallel degree {tp} does not divide the "
                f"{len(ranks)}-rank mesh: fan-in gives each of the "
                f"{workers} prefill workers {len(groups[0])} and decode "
                f"{len(dec)} of the {n} ranks, so --tp must divide those")
        key = (tuple(ranks), tp)
        if key not in built:
            built[key] = _rank_mesh(ranks, tp, dtype)
        return built[key]
    pres = [mk(g, tp_prefill) for g in groups]
    return pres, mk(dec, tp_decode)


def disagg_decode_report(cfg, batch: int, seq_len: int, mesh, *,
                         ici_bw: float, hbm_bw: float,
                         transfers=collectives.CACHE_TRANSFERS,
                         storages=collectives.KV_STORAGES,
                         blocks=(collectives.ACT_BLOCK,), params=None,
                         seed: int = 0):
    """The disaggregated-decode design space on one mesh: every
    cache_transfer x kv_storage (x stream block) combination, priced by
    the wire of the collectives each rank issues.

    Every rank of ``mesh`` calls it. Each program runs once on the mesh
    under ``launch.analysis.collective_meter`` (every collective the
    program issues, DTensor's own included, priced by the ring model; the
    reference compiles each program and parses its HLO collective bytes):
    the serve_sp -> serve_decode cache transfer of a ``batch x seq_len``
    cache, the per-slot admission of one request's ``[1, seq_len]`` slice
    (serve_sp layout) into a serve_decode slot table, and one decode step
    per storage arm. ``*_bf16eq`` prices f32 payloads at bf16 bytes, as
    the reference does; ``*_s8`` is the int8 part. The report's keys,
    structure and model are the reference's: per combination
    ``"<transfer>x<storage>"`` ``transfer_s``, ``decode_step_s``,
    ``collective_s`` (wire bytes over ``ici_bw``),
    ``cache_resident_bytes_per_device`` (from ``resolve_spec``, equal to
    the reference's) and ``slot_stream_overlap_frac``; then
    ``slot_stream``, ``block_sweep``, ``hide_steps``, ``tuned``
    (``core.autotune.tune_design`` over transfer x storage x block of
    wire plus the resident cache's read at ``hbm_bw``),
    ``unsupported_storage`` and ``skipped``.

    ``ici_bw`` and ``hbm_bw`` (bytes/s) have no default: the link and the
    memory of the machine being priced, e.g. an NVIDIA H100 SXM's
    NVLink 4 at 450e9 per direction and HBM3 at 3.35e12. ``params``
    (full, on this rank's device) default to ``init_params(cfg, seed)``
    on the card.
    """
    from repro_torch.core import autotune

    transfers = tuple(transfers)
    storages = tuple(storages)
    blocks = tuple(blocks)
    pre_rules = shd.PRESETS["serve_sp"]
    dec_rules = shd.PRESETS["serve_decode"]
    if not _ranked(mesh):
        dev = torch.device(mesh.devices.flat[0])
    elif mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(mesh.device_type)
    if params is None:
        params = transformer.init_params(cfg, seed=seed, device=dev)
    c_abs = transformer.abstract_cache(cfg, batch, seq_len)
    c_axes = transformer.cache_axes(cfg, batch, seq_len)
    slice_abs = transformer.abstract_cache(cfg, 1, seq_len)
    slice_axes = transformer.cache_axes(cfg, 1, seq_len)
    gen = torch.Generator().manual_seed(seed)

    def filled(abs_tree):
        return tree_map(lambda s: (torch.randn(s.shape, generator=gen)
                                   .to(s.dtype).to(dev)),
                        abs_tree, is_leaf=is_tensor_spec)

    from repro_torch.launch.analysis import collective_meter as wire

    skipped = {}
    slot_ok = supports_slot_streaming(cfg)
    if not slot_ok:
        try:
            _require_slot_streaming(cfg)
        except NotImplementedError as e:
            skipped["--stream slots"] = str(e)
    cache = _place(filled(c_abs), c_axes, mesh, pre_rules)
    slc = _place(filled(slice_abs), slice_axes, mesh, pre_rules)
    table = _place(transformer.zeros_like_spec(c_abs, dev),
                   _rename_slots(c_axes), mesh, dec_rules)
    t_coll, slot_coll = {}, {}
    with torch.no_grad(), shd.axis_rules(mesh, dec_rules):
        for t in transfers:
            for blk in (blocks if t == "int8" else blocks[:1]):
                fn = make_cache_transfer_step(cfg, batch, seq_len, t,
                                              block=blk)
                t_coll[(t, blk)] = wire(lambda: fn(cache))
                if not slot_ok:
                    continue
                admit = make_slot_admit_step(cfg, batch, seq_len, t, "bf16",
                                             block=blk)
                slot_coll[(t, blk)] = wire(lambda: admit(table, slc, 0))

    def device_bytes(abs_tree, axes_tree):
        tot = 0.0
        for leaf, la in zip(tree_leaves(abs_tree, is_leaf=is_tensor_spec),
                            tree_leaves(axes_tree, is_leaf=is_axes)):
            spec = shd.resolve_spec(leaf.shape, tuple(la), mesh, dec_rules)
            shards = shd.spec_shard_count(spec, mesh)
            tot += float(np.prod(leaf.shape)) * leaf.dtype.itemsize / shards
        return int(tot)

    decodes, cache_bytes, unsupported = {}, {}, []
    p_dec = _place(params, transformer.param_axes(cfg), mesh, dec_rules)
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    pos = torch.tensor(seq_len - 1, dtype=torch.int32, device=dev)
    for s in storages:
        try:
            fn = step_lib.make_decode_step(cfg, seq_len, "bf16", s)
        except NotImplementedError as e:
            unsupported.append(s)
            skipped[f"kv_storage={s!r}"] = str(e)
            continue
        cs_abs = transformer.abstract_cache(cfg, batch, seq_len,
                                            kv_storage=s)
        cs_axes = transformer.cache_axes(cfg, batch, seq_len, kv_storage=s)
        with torch.no_grad():
            cs = _place(transformer.quantize_cache(filled(c_abs), s),
                        cs_axes, mesh, dec_rules)
            with shd.axis_rules(mesh, dec_rules):
                decodes[s] = wire(lambda: fn(p_dec, cs, {"tokens": tok,
                                                         "pos": pos}))
        cache_bytes[s] = device_bytes(cs_abs, cs_axes)

    # steady-state decode budget per admission: all batch slots serving
    # ~seq_len-token requests readmit one slot every seq_len/batch steps
    hide_steps = max(1, seq_len // max(1, batch))
    blk0 = blocks[0]

    def _tb(t, blk):
        return t_coll[(t, blk if t == "int8" else blk0)]

    def _sb(t, blk):
        return slot_coll[(t, blk if t == "int8" else blk0)]

    cells = {}
    for t in transfers:
        tcoll = _tb(t, blk0)
        for s, dcoll in decodes.items():
            tw = float(tcoll["total_wire_bytes_bf16eq"])
            dw = float(dcoll["total_wire_bytes_bf16eq"])
            cells[f"{t}x{s}"] = {
                "transfer_s": tw / ici_bw,
                "decode_step_s": dw / ici_bw,
                "collective_s": (tw + dw) / ici_bw,
                "transfer_wire_bytes_bf16eq": int(tw),
                "transfer_wire_bytes_bf16eq_s8":
                    int(tcoll["total_wire_bytes_bf16eq_s8"]),
                "decode_wire_bytes_bf16eq": int(dw),
                "cache_resident_bytes_per_device": cache_bytes[s],
            }
            if slot_ok:
                sw = float(_sb(t, blk0)["total_wire_bytes_bf16eq"])
                slot_s = sw / ici_bw
                hidden = min(slot_s, hide_steps * dw / ici_bw)
                cells[f"{t}x{s}"]["slot_stream_overlap_frac"] = \
                    1.0 if sw == 0 else hidden / slot_s

    slot_stream = {}
    for t in (transfers if slot_ok else ()):
        sc = _sb(t, blk0)
        slot_stream[t] = {
            "wire_bytes_bf16eq": int(sc["total_wire_bytes_bf16eq"]),
            "wire_bytes_bf16eq_s8":
                int(sc["total_wire_bytes_bf16eq_s8"]),
            "transfer_s": float(sc["total_wire_bytes_bf16eq"]) / ici_bw,
            "hide_steps": hide_steps,
        }

    block_sweep = {
        t: {int(blk): {
            "transfer_wire_bytes_bf16eq":
                int(_tb(t, blk)["total_wire_bytes_bf16eq"]),
            **({"slot_wire_bytes_bf16eq":
                int(_sb(t, blk)["total_wire_bytes_bf16eq"])}
               if slot_ok else {}),
        } for blk in (blocks if t == "int8" else blocks[:1])}
        for t in transfers}

    def objective(point):
        # wire (one transfer + one decode step) + the decode step's HBM
        # read of the resident cache -- the term the storage arm halves
        tw = float(_tb(point["cache_transfer"],
                       point["block"])["total_wire_bytes_bf16eq"])
        s = point["kv_storage"]
        dw = float(decodes[s]["total_wire_bytes_bf16eq"])
        return (tw + dw) / ici_bw + cache_bytes[s] / hbm_bw

    tuned = None
    if decodes:
        res = autotune.tune_design(objective, {
            "cache_transfer": transfers,
            "kv_storage": tuple(decodes),
            "block": blocks,
        })
        tuned = {"point": res.best_point,
                 "collective_s": res.best_objective,
                 "evaluations": res.evaluations}

    return {"cells": cells, "unsupported_storage": unsupported,
            "skipped": skipped,
            "slot_stream": slot_stream, "block_sweep": block_sweep,
            "hide_steps": hide_steps, "tuned": tuned}


def _rename_slots(axes_tree):
    """Cache axes with the batch dim named "slots": a slot table's."""
    return tree_map(lambda la: tuple("slots" if a == "batch" else a
                                     for a in la), axes_tree, is_leaf=is_axes)


def fanin_report(cfg, batch: int, seq_len: int, *, workers: int = 2,
                 slots: int = 0, classes: int = 2, evict: str = "priority",
                 max_new: int = 0, decode_step_s: float = 0.0,
                 transfer_s: float = 0.0, page: int = 0,
                 kv_storage: str = "bf16"):
    """Deterministic fan-in roofline: drive the real
    :class:`repro_torch.dist.fanin.AdmissionArbiter` through a contended
    serving trace and price the outcome with the disagg report's per-step
    costs. No wall clock, no device: the same inputs always give the same
    report, equal to the reference's.

    ``batch`` requests with a seeded mixed-length spread and round-robin
    priority classes contend for a ``slots``-row table (default
    ``batch // 2``: contention by construction) fed by ``workers``
    prefill workers; each simulated cycle is one decode step of cost
    ``decode_step_s``, and a dispatched prefill+transfer costs
    ``transfer_s``, double-buffered behind the queue wait. Reported:

    * ``fanin_admission_wait_s`` -- mean per-admission latency: queue
      wait (arbiter passes lost x decode step) plus the transfer time the
      overlap failed to hide;
    * ``fanin_evictions`` -- preemptions the policy performed (each costs
      a re-prefill of the extended prompt);
    * ``paged_hbm_bytes_per_slot`` vs ``slot_hbm_bytes_per_slot`` -- the
      paged table's live-page resident rent per slot against the dense
      pad-to-horizon baseline (only for families with the ``paged``
      capability; refusals land in ``skipped``).
    """
    max_new = int(max_new) or max(1, seq_len // 8)
    n_slots = int(slots) or max(1, batch // 2)
    rng = np.random.RandomState(0)
    lens = rng.randint(max(1, seq_len // 4), seq_len + 1,
                       size=(batch,)).astype(np.int64)

    arb = fanin.AdmissionArbiter(workers=workers, classes=classes)
    reqs = [fanin.Request(rid=i, prompt=np.zeros((int(lens[i]),), np.int32),
                          max_new=max_new, priority=int(i % classes))
            for i in range(batch)]
    for r in reqs:
        arb.submit(r)
    remaining = {r.rid: max_new for r in reqs}
    emitted = {r.rid: 0 for r in reqs}
    occ: list = [None] * n_slots
    occ_req: list = [None] * n_slots
    wait_s: list = []
    cycles = 0
    limit = 1000 + 20 * batch * (max_new + n_slots + arb.promotion_cycles)

    def free_row(s):
        occ[s] = None
        occ_req[s] = None

    while True:
        arb.assign()
        while True:
            req = arb.next_admission()
            if req is None:
                break
            s = next((i for i in range(n_slots) if occ[i] is None), None)
            if s is None:
                s = arb.pick_victim(occ, evict, req)
                if s is None:
                    break
                victim = occ_req[s]
                arb.evicted(victim)
                victim.prompt = np.zeros(
                    (int(lens[victim.rid]) + emitted[victim.rid],),
                    np.int32)
                victim.max_new = remaining[victim.rid]
                free_row(s)
                arb.submit(victim, requeue=True)
            queue_wait = req.skips * decode_step_s
            wait_s.append(queue_wait + max(0.0, transfer_s - queue_wait))
            o = arb.admit(req)
            occ[s] = o
            occ_req[s] = req
            emitted[req.rid] += 1       # the prefill token
            remaining[req.rid] -= 1
            if remaining[req.rid] <= 0:
                free_row(s)
        arb.age()
        if all(o_ is None for o_ in occ):
            if not arb.queue:
                break
            continue
        cycles += 1                     # one decode step over the table
        for s in range(n_slots):
            r = occ_req[s]
            if r is None:
                continue
            emitted[r.rid] += 1
            remaining[r.rid] -= 1
            if remaining[r.rid] <= 0:
                free_row(s)
        if cycles > limit:
            raise RuntimeError("fan-in report simulation made no progress")

    rep = {"workers": workers, "slots": n_slots, "classes": classes,
           "evict": evict, "decode_cycles": cycles,
           "fanin_admission_wait_s":
               float(np.mean(wait_s)) if wait_s else 0.0,
           "fanin_evictions": int(arb.stats["evictions"]),
           "max_wait_passes": int(arb.stats["max_wait"]),
           "skipped": {}}

    caps = registry.capabilities(cfg)
    if caps.paged:
        base = seq_len + max_new
        P = int(page) or _default_page(base)
        total = -(-base // P) * P
        store = registry.paged_state_store(cfg, n_slots, total,
                                           kv_storage=kv_storage, page=P)
        per_pos = store.page_bytes() / P
        live = np.minimum(lens + max_new, total)
        paged_bytes = float(np.mean(-(-live // P) * P * per_pos))
        dense = sum(l.nbytes for l in store.dense_abstract_state().values())
        rep["page"] = P
        rep["paged_hbm_bytes_per_slot"] = paged_bytes
        rep["slot_hbm_bytes_per_slot"] = float(dense / n_slots)
    else:
        try:
            registry.require(cfg, "paged", "--paged")
        except NotImplementedError as e:
            rep["skipped"]["--paged"] = str(e)
    return rep


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--full", action="store_true",
                    help="serve the published config instead of the "
                         "reduced smoke config (the default)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--tp", type=int, default=0,
                    help="model-parallel degree (0 = auto)")
    ap.add_argument("--preset", default="serve_sp",
                    choices=tuple(sorted(shd.PRESETS)))
    ap.add_argument("--act-transport", default="bf16",
                    choices=list(step_lib.ACT_TRANSPORTS))
    ap.add_argument("--ragged", action="store_true",
                    help="serve a mixed-length batch (continuous batching)")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregate: prefill and decode on separate "
                         "meshes (half the ranks each), the cache handed "
                         "off between them")
    ap.add_argument("--cache-transfer", default="bf16",
                    choices=list(step_lib.CACHE_TRANSFERS),
                    help="wire format of the disagg prefill->decode cache "
                         "handoff")
    ap.add_argument("--kv-storage", default="bf16",
                    choices=list(step_lib.KV_STORAGES),
                    help="decode-resident cache dtype (int8: s8 + scales, "
                         "f8: scale-free e4m3)")
    ap.add_argument("--stream", default="batch", choices=list(STREAMS),
                    help="handoff granularity: 'batch' prefills the whole "
                         "batch then decodes it; 'slots' streams each "
                         "request's cache slice into a running decode "
                         "batch via slot admission")
    ap.add_argument("--slots", type=int, default=0,
                    help="slot-table size for --stream slots (0 = one "
                         "slot per request; smaller forces slot reuse)")
    ap.add_argument("--workers", type=int, default=1,
                    help="prefill fan-in: N prefill workers feeding one "
                         "decode slot table through the admission arbiter "
                         "(>1, or --paged, routes serving through the "
                         "fan-in engine; greedy only)")
    ap.add_argument("--evict", default="oldest",
                    choices=list(fanin.EVICTION_POLICIES),
                    help="slot preemption policy when the table is full "
                         "and a pending request outranks an occupant")
    ap.add_argument("--paged", action="store_true",
                    help="paged slot cache: rows are lists of fixed-size "
                         "pages in a shared pool with a per-slot page "
                         "table")
    ap.add_argument("--page-size", type=int, default=0,
                    help="positions per page for --paged (0 = the tuned "
                         "paged_attn registry point, default 256)")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="page-pool size backing the paged table (0 = "
                         "fully backed: slots x pages-per-row)")
    ap.add_argument("--horizon", type=int, default=0,
                    help="decode horizon in positions (0 = prompt-len + "
                         "max-new); an unpaged request that cannot fit "
                         "is refused, never silently truncated")
    ap.add_argument("--priority-classes", type=int, default=1,
                    help="admission priority classes for the fan-in "
                         "arbiter, round-robin assigned to the batch")
    ap.add_argument("--device", default="cuda",
                    help="where to serve: the card (default) or 'cpu'")
    return ap


def resolve_config(args):
    """--full serves the published config; the default is the smoke
    config (same family and code paths, CPU-runnable dims)."""
    return get_config(args.arch) if args.full else smoke_config(args.arch)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = resolve_config(args)
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only; no decode serving")
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        device = init_ranks(pick_backend(args.device,
                                         int(os.environ["WORLD_SIZE"])),
                            device=args.device)          # under torchrun
    else:
        device = resolve_device(args.device, "launch.serve")
    rank0 = not dist.is_initialized() or dist.get_rank() == 0

    fan_in = args.workers > 1 or args.paged
    prefill_meshes = None
    decode_mesh = decode_rules = None
    if args.disagg:
        if fan_in:
            prefill_meshes, decode_mesh = make_fanin_meshes(
                cfg, max(1, args.workers), args.tp, args.tp, device=device)
            mesh = prefill_meshes[0]
        else:
            mesh, decode_mesh = make_disagg_meshes(cfg, args.tp, args.tp,
                                                   device=device)
        rules = shd.PRESETS[args.preset]
        decode_rules = shd.PRESETS["serve_decode"]
    else:
        world = dist.get_world_size() if dist.is_initialized() else 1
        tp = args.tp or _pick_tp(world, cfg)
        mesh = make_local_mesh(model_parallel=tp, device=device)
        rules = shd.PRESETS[args.preset]

    params = transformer.init_params(cfg, seed=0, device=device)
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab,
                          size=(args.batch, args.prompt_len)).astype(np.int32)
    lens = None
    if args.ragged:
        lens = rng.randint(max(1, args.prompt_len // 2), args.prompt_len + 1,
                           size=(args.batch,)).astype(np.int32)
    prios = None
    if args.priority_classes > 1:
        prios = (np.arange(args.batch)
                 % args.priority_classes).astype(np.int32)

    t0 = time.time()
    out = generate(cfg, params, prompts, max_new=args.max_new,
                   temperature=args.temperature, prompt_lens=lens,
                   mesh=mesh, rules=rules, act_transport=args.act_transport,
                   decode_mesh=decode_mesh, decode_rules=decode_rules,
                   cache_transfer=args.cache_transfer,
                   kv_storage=args.kv_storage,
                   stream=args.stream, slots=args.slots,
                   workers=args.workers, evict=args.evict,
                   paged=args.paged, page_size=args.page_size,
                   pool_pages=args.pool_pages, horizon=args.horizon,
                   priorities=prios, prefill_meshes=prefill_meshes)
    dt = time.time() - t0
    if not rank0:
        return
    n_tok = out.size
    mesh_desc = shd.axis_sizes(mesh)
    if decode_mesh is not None:
        mesh_desc = {"prefill": shd.axis_sizes(mesh),
                     "decode": shd.axis_sizes(decode_mesh)}
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"prompt={args.prompt_len} new={args.max_new} "
          f"mesh={mesh_desc} "
          f"preset={args.preset} act_transport={args.act_transport} "
          f"disagg={args.disagg} cache_transfer={args.cache_transfer} "
          f"kv_storage={args.kv_storage} stream={args.stream}"
          + (f" lens={lens.tolist()}" if lens is not None else ""))
    print(f"[serve] generated {n_tok} tokens in {dt:.2f}s "
          f"({n_tok/dt:.1f} tok/s)")
    if fan_in:
        st = _generate_fanin.last_stats
        print(f"[serve] fan-in: workers={args.workers} evict={args.evict} "
              f"admissions={st['admissions']} evictions={st['evictions']} "
              f"requeues={st['requeues']} decode_steps={st['decode_steps']} "
              f"transfer_wait_s={st['transfer_wait_s']:.3f} "
              f"max_wait_passes={st['max_wait_passes']}")
        if args.paged:
            print(f"[serve] paged: page={st['page']} "
                  f"peak_live_pages={st['peak_live_pages']} "
                  f"hbm_bytes_per_slot={st['hbm_bytes_per_slot']} "
                  f"(dense pad-to-horizon "
                  f"{st['dense_hbm_bytes_per_slot']})")
    elif args.stream == "slots":
        st = _generate_slots.last_stats
        print(f"[serve] slot stream: admissions={st['admissions']} "
              f"decode_steps={st['decode_steps']} "
              f"transfer_wait_s={st['transfer_wait_s']:.3f} "
              "(the host's wait for each admitted shipment)")
    print("[serve] sample:", out[0][:10])


if __name__ == "__main__":
    main()
