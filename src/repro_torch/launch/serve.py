"""Serving launcher on one device: batched prefill + decode with a KV
cache, the int8 and f8 resident caches, slot streaming and the fan-in
engine.

The port of ``src/repro/launch/serve.py``, its one-device part.
``python -m repro_torch.launch.serve --arch granite-3-8b`` runs a batched
generation loop on the reduced smoke config (``--full`` serves the
published config) on the card; ``--device cpu`` runs it on the host.

Modes, each as the reference's on a (1, 1) mesh:

* whole-batch serving (``stream="batch"``): uniform or ragged
  (``prompt_lens``) prompts, prefilled together and decoded together;
* ``kv_storage`` "bf16", "int8" (s8 values + f32 scales per block of the
  feature axis) or "f8" (scale-free e4m3) for the decode-resident cache;
* ``act_transport`` "bf16" or "int8": on one device the int8 gather moves
  nothing, but its quantize-dequantize round trip changes the values, as
  the reference's does;
* ``stream="slots"``: each request prefilled alone and admitted into a
  free row of a running decode batch (``cache_transfer`` "int8" rounds the
  slice through the seq-blockwise s8 stream);
* the fan-in engine (``workers > 1`` or ``paged=True``): prefill workers
  feed one slot table through ``dist.fanin.AdmissionArbiter``, with
  priority classes, recompute preemption (``evict``) and an optional
  paged slot table (``models.registry.PagedStateStore``).

Eager torch has no asynchronous dispatch of whole programs: a prefill
shipment and the decode steps are enqueued on the card's one stream in
the order the host issues them. The engine admits in the arbiter's order
exactly as the reference does, so ``admissions``, ``evictions``,
``requeues`` and ``decode_steps`` equal the reference's. The reference
writes caches with ``dynamic_update_slice``, which clamps a start so the
update fits; every start this module writes (a slot row, a ring slot, a
page) lies inside its buffer by construction, and ``update_slice``
clamps as XLA does where a start comes from a caller.

Sampling (``temperature > 0``) draws from a ``torch.Generator`` seeded by
``seed``: the same seed gives the same tokens, but not
``jax.random.categorical``'s. Greedy decoding gives the reference's tokens.

Waiting for serving across ranks (ROADMAP queue 1, item 3b; training
across ranks is ``launch.train``'s), each raising
``NotImplementedError``: ``decode_mesh`` and ``prefill_meshes``, a mesh
of more than one device, ``--disagg``, ``--tp`` > 1,
``make_cache_mover``, ``make_disagg_meshes``, ``make_fanin_meshes``,
``disagg_decode_report`` and ``fanin_report``.
"""

from __future__ import annotations

import argparse
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.dist import collectives, fanin
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import registry, transformer
from repro_torch.models.common import resolve_device, tree_leaves, tree_map
from repro_torch.models.transformer import is_axes, is_tensor_spec
from repro_torch.train import step as step_lib

STREAMS = ("batch", "slots")
# the reference's sharding presets; on one device each is the identity
PRESET_NAMES = ("baseline", "ddp", "ep", "fsdp", "serve_decode", "serve_sp",
                "sp")


def _multi_device(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: serving across devices comes with serving across ranks "
        "(ROADMAP queue 1, item 3b); serving runs on one device")


def grow_cache(cache, target):
    """Grow every cache leaf to the decode-horizon shape (end-padding).

    ``target`` is the decode cache's ``TensorSpec`` tree, so windowed, SSM
    and xLSTM states are handled uniformly: leaves already at the target
    shape only cast, anything smaller pads with zeros at the end of each
    dimension (new slots read as empty and are masked by slot-position
    validity until written).
    """
    def grow(tgt, c):
        if tuple(c.shape) == tgt.shape:
            return c.to(tgt.dtype)
        if any(s > t for s, t in zip(c.shape, tgt.shape)):
            raise ValueError(f"grow_cache: leaf {tuple(c.shape)} is larger "
                             f"than its target {tgt.shape}")
        out = torch.zeros(tgt.shape, dtype=tgt.dtype, device=c.device)
        out[tuple(slice(0, s) for s in c.shape)] = c.to(tgt.dtype)
        return out

    return tree_map(grow, target, cache, is_leaf=is_tensor_spec)


def fit_cache(cache, target):
    """:func:`grow_cache` that can also shrink: every leaf is sliced to
    the target extent before padding. A fresh paged admission ships
    ``ceil(len / page)`` pages, which may be fewer positions than the
    ``[1, S0]`` prefill buffer (the dropped tail is pad junk beyond the
    request's live length), while a readmitted request's exact-length
    prefill pads up to the next page boundary.
    """
    def fit(tgt, c):
        if tuple(c.shape) == tgt.shape:
            return c.to(tgt.dtype)
        c = c[tuple(slice(0, min(s, t)) for s, t in zip(c.shape, tgt.shape))]
        out = torch.zeros(tgt.shape, dtype=tgt.dtype, device=c.device)
        out[tuple(slice(0, s) for s in c.shape)] = c.to(tgt.dtype)
        return out

    return tree_map(fit, target, cache, is_leaf=is_tensor_spec)


def make_cache_transfer_step(cfg, batch: int, total: int, mode: str,
                             block: int = collectives.ACT_BLOCK):
    """The prefill->decode cache handoff on one device.

    Returns ``transfer(cache) -> cache``: ``mode="int8"`` routes leaves
    with a sequence axis through ``collectives.stream_int8`` (seq-blockwise
    s8 chunks + scales, ``block`` positions per chunk, dequantized on
    arrival), everything else (recurrent state, ``mode="bf16"``) moves
    raw. On one device nothing crosses a wire; the int8 round trip's
    rounding is real.
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
            return shd.constrain(leaf, *la)
        return tree_map(move, axes, cache, is_leaf=is_axes)
    return transfer


def make_cache_mover(*args, **kwargs):
    """The two-mesh cache handoff of disaggregated serving."""
    raise _multi_device("make_cache_mover")


def make_disagg_meshes(*args, **kwargs):
    raise _multi_device("make_disagg_meshes")


def make_fanin_meshes(*args, **kwargs):
    raise _multi_device("make_fanin_meshes")


def disagg_decode_report(*args, **kwargs):
    """The reference prices each transfer x storage arm with the compiled
    programs' HLO collective bytes (``launch.analysis``)."""
    raise _multi_device("disagg_decode_report")


def fanin_report(*args, **kwargs):
    raise _multi_device("fanin_report")


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


def _check_mesh(mesh) -> None:
    """A (1, 1) mesh is the one device; any larger mesh waits."""
    size = 1 if mesh is None else \
        int(np.prod(list(shd.axis_sizes(mesh).values())))
    if size != 1:
        raise _multi_device(f"a mesh of {size} devices")


def _params_device(params) -> torch.device:
    return tree_leaves(params)[0].device


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
    lg = logits.float().cpu() / temperature
    u = torch.rand(lg.shape, generator=gen).clamp_(min=1e-20)
    return torch.argmax(lg - torch.log(-torch.log(u)), -1).numpy() \
        .astype(np.int32)


def _row_generator(seed: int, i: int) -> torch.Generator:
    """Request ``i``'s own stream of draws under ``seed`` (the
    reference's ``fold_in(key, i)``)."""
    state = np.random.SeedSequence([seed, i]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


@torch.inference_mode()
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
    int32. Runs where ``params`` are.

    ``prompt_lens`` (B,) enables ragged continuous batching: row i's real
    prompt is ``prompts[i, :prompt_lens[i]]``; every row decodes from its
    own position and pad slots are masked. ``kv_storage`` picks the
    decode-resident cache dtype, ``act_transport`` the activation
    gather's wire format. ``stream="slots"`` streams each request into a
    running decode batch (:func:`_generate_slots`); ``workers > 1`` or
    ``paged=True`` routes through the fan-in engine
    (:func:`_generate_fanin`). ``horizon`` caps the decode horizon in
    positions (0 = sized to fit). ``mesh`` may be a one-device mesh
    (``launch.mesh.make_local_mesh``); ``rules`` has no effect on one
    device.
    """
    if stream not in STREAMS:
        raise ValueError(f"unknown stream {stream!r}; "
                         f"expected one of {STREAMS}")
    if decode_mesh is not None or decode_rules is not None:
        raise _multi_device("disaggregated serving (decode_mesh=...)")
    if prefill_meshes is not None:
        raise _multi_device("fan-in prefill meshes (prefill_meshes=...)")
    _check_mesh(mesh)
    if workers > 1 or paged:
        return _generate_fanin(
            cfg, params, prompts, max_new=max_new, temperature=temperature,
            prompt_lens=prompt_lens, act_transport=act_transport,
            cache_transfer=cache_transfer, kv_storage=kv_storage,
            slots=slots, workers=workers, evict=evict, paged=paged,
            page_size=page_size, pool_pages=pool_pages, horizon=horizon,
            priorities=priorities)
    if stream == "slots":
        return _generate_slots(
            cfg, params, prompts, max_new=max_new, temperature=temperature,
            seed=seed, prompt_lens=prompt_lens, act_transport=act_transport,
            cache_transfer=cache_transfer, kv_storage=kv_storage,
            slots=slots, horizon=horizon)
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
    dev = _params_device(params)
    prefill = step_lib.make_prefill_step(cfg, act_transport)
    # validates kv_storage (and the family's eligibility for it)
    decode = step_lib.make_decode_step(cfg, total, act_transport, kv_storage)

    pre_batch = {"tokens": _tokens(prompts, dev)}
    if ragged:
        pre_batch["last_pos"] = _tokens(lens - 1, dev)
    logits, cache = prefill(params, pre_batch)
    cache = grow_cache(cache, transformer.abstract_cache(cfg, b, total))
    cache = transformer.quantize_cache(cache, kv_storage)

    gen = torch.Generator().manual_seed(seed)
    out_tokens = []
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    for i in range(max_new):
        out_tokens.append(tok.cpu().numpy())
        pos = _tokens(lens + i, dev) if ragged else _tokens(s0 + i, dev)
        logits, cache = decode(params, cache, {"tokens": tok, "pos": pos})
        if temperature > 0:
            tok = _tokens(_sample(logits, temperature, gen)[:, None], dev)
        else:
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
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
    ``transfer="int8"`` rounds each sequence-carrying leaf through
    ``collectives.stream_slot_int8`` and each O(1) row-state leaf through
    ``collectives.stream_row_int8``."""
    if transfer not in collectives.CACHE_TRANSFERS:
        raise ValueError(f"unknown cache_transfer {transfer!r}; "
                         f"expected one of {collectives.CACHE_TRANSFERS}")
    _require_slot_streaming(cfg)
    store = registry.state_store(cfg, slots, total, kv_storage=kv_storage)

    @torch.inference_mode()
    def admit(cache, slc, slot):
        return store.admit_row(cache, slc, slot, transfer=transfer,
                               block=block)
    return admit


def _generate_slots(cfg, params, prompts: np.ndarray, max_new: int,
                    temperature: float, seed: int,
                    prompt_lens: Optional[np.ndarray], act_transport: str,
                    cache_transfer: str, kv_storage: str, slots: int,
                    horizon: int = 0):
    """Continuous slot streaming: each request is prefilled on its own and
    its cache slice admitted into a free row of a RUNNING decode batch.

    The decode side holds a slot table of ``slots`` rows. Each request is
    prefilled alone -- ``[1, S0]`` with a last position for dense caches,
    ``[1, len_i]`` exact-length for ``row_state`` families -- its grown
    slice admitted into a free slot (:func:`make_slot_admit_step`), and
    the slot decodes from the request's own position while other slots
    are mid-decode or empty. A finished slot is freed and reused by the
    next pending request; admission overwrites the whole row. The next
    pending request's prefill is issued at admission time, before the
    decode steps that follow (the reference's double buffer).

    ``_generate_slots.last_stats`` holds ``admissions``,
    ``decode_steps`` and ``transfer_wait_s``: the host's wait, at
    admission, for the shipment's tensors to be ready. The prefill was
    enqueued on the same stream as the decode steps since, whose own
    syncs have usually retired it, so on the card the wait is near zero;
    on the host it is zero.
    """
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
    dev = _params_device(params)

    prefill = step_lib.make_prefill_step(cfg, act_transport)
    decode = step_lib.make_decode_step(cfg, total, act_transport, kv_storage)
    slice_abs = transformer.abstract_cache(cfg, 1, total)
    admit = make_slot_admit_step(cfg, n_slots, total, cache_transfer,
                                 kv_storage)
    cache = registry.state_store(cfg, n_slots, total,
                                 kv_storage=kv_storage).init_state(dev)

    # ---- host-side slot table + the prefetched shipment ----------------
    out_tokens = [[] for _ in range(b)]
    slot_req = [-1] * n_slots          # request id per slot, -1 = free
    slot_tok = np.zeros((n_slots,), np.int32)
    slot_pos = np.zeros((n_slots,), np.int32)
    slot_gen: list = [None] * n_slots
    next_req = 0
    inflight: list = []                # at most one prefetched shipment
    stats = {"admissions": 0, "transfer_wait_s": 0.0, "decode_steps": 0}

    def start_prefetch():
        """Prefill the next pending request and grow its slice."""
        nonlocal next_req
        if next_req >= b or inflight:
            return
        i = next_req
        next_req += 1
        if caps.row_state:
            # ring-buffer / recurrent state: pad tokens must never enter
            # the per-row state, so the request is prefilled at its length
            logits, c = prefill(params, {
                "tokens": _tokens(prompts[i:i + 1, :lens[i]], dev)})
        else:
            logits, c = prefill(params, {
                "tokens": _tokens(prompts[i:i + 1], dev),
                "last_pos": _tokens(lens[i:i + 1] - 1, dev)})
        slc = grow_cache(c, slice_abs)
        tok0 = torch.argmax(logits, -1).to(torch.int32)
        inflight.append((i, slc, tok0))

    def emit(i, t, slot):
        out_tokens[i].append(int(t))
        if len(out_tokens[i]) >= max_new:
            slot_req[slot] = -1        # free the slot for reuse

    def admit_next(slot):
        nonlocal cache
        if not inflight:
            start_prefetch()
        i, slc, tok0 = inflight.pop(0)
        t0 = time.perf_counter()
        _wait(slc)
        stats["transfer_wait_s"] += time.perf_counter() - t0
        cache = admit(cache, slc, slot)
        stats["admissions"] += 1
        slot_req[slot] = i
        slot_pos[slot] = lens[i]
        slot_tok[slot] = int(tok0.cpu()[0])
        slot_gen[slot] = _row_generator(seed, i)
        emit(i, slot_tok[slot], slot)  # the prefill token
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
        logits, cache = decode(params, cache, {
            "tokens": _tokens(slot_tok[:, None], dev),
            "pos": _tokens(slot_pos, dev)})
        stats["decode_steps"] += 1
        if temperature > 0:
            nxt = np.zeros((n_slots,), np.int32)
            for s_ in range(n_slots):
                if slot_req[s_] < 0:
                    continue
                nxt[s_] = _sample(logits[s_], temperature, slot_gen[s_])
        else:
            nxt = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
        for s_ in range(n_slots):
            i = slot_req[s_]
            if i < 0:
                continue
            slot_tok[s_] = nxt[s_]
            slot_pos[s_] += 1
            emit(i, nxt[s_], s_)

    assert all(len(ts) == max_new for ts in out_tokens)
    _generate_slots.last_stats = stats     # launcher reporting hook
    return np.asarray(out_tokens, np.int32)


def _generate_fanin(cfg, params, prompts: np.ndarray, max_new: int,
                    temperature: float, prompt_lens: Optional[np.ndarray],
                    act_transport: str, cache_transfer: str,
                    kv_storage: str, slots: int, workers: int, evict: str,
                    paged: bool, page_size: int, pool_pages: int,
                    horizon: int, priorities: Optional[np.ndarray]):
    """Multi-prefill-worker fan-in with slot preemption and an optional
    paged slot cache.

    ``workers`` prefill workers feed ONE decode slot table. Admission
    order is owned by :class:`repro_torch.dist.fanin.AdmissionArbiter`
    (FIFO with priority classes, aging + hard promotion, per-worker
    in-flight accounting); the engine admits the arbiter's chosen
    shipment, never whichever finished first. On one device every worker
    prefills on the same card, in the order the arbiter assigns them.

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
    dev = _params_device(params)

    prefill = step_lib.make_prefill_step(cfg, act_transport)
    decode_fn = step_lib.make_decode_step(cfg, total, act_transport,
                                          kv_storage)
    fit_abs = {}

    def fit(c, width):
        if width not in fit_abs:
            fit_abs[width] = transformer.abstract_cache(cfg, 1, width)
        return fit_cache(c, fit_abs[width])

    # ---- decode-side programs: slot table (dense or paged) --------------
    if paged:
        store = registry.paged_state_store(
            cfg, n_slots, total, kv_storage=kv_storage, page=P,
            pool_pages=int(pool_pages))

        @torch.inference_mode()
        def admit(cache, slc, page_idx):
            return store.admit_pages(cache, slc, page_idx,
                                     transfer=cache_transfer)

        @torch.inference_mode()
        def decode(p, pool, pt, batch):
            dense = store.gather_dense(pool, pt)
            logits, dense = decode_fn(p, dense, batch)
            return logits, store.scatter_dense(pool, dense, pt)
    else:
        store = registry.state_store(cfg, n_slots, total,
                                     kv_storage=kv_storage)
        admit = make_slot_admit_step(cfg, n_slots, total, cache_transfer,
                                     kv_storage)
        decode = decode_fn
    cache = store.init_state(dev)

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
        """Prefill one assigned request and fit its slice for shipment."""
        plen = int(req.prompt.shape[0])
        if req.evictions == 0 and not caps.row_state and plen <= s0:
            # fresh admission: padded [1, S0] prefill with a last position
            toks = np.zeros((1, s0), np.int32)
            toks[0, :plen] = req.prompt
            logits, c = prefill(params, {"tokens": _tokens(toks, dev),
                                         "last_pos": _tokens([plen - 1], dev)})
        else:
            # readmission (or row_state): exact-length prefill of the
            # extended prompt
            logits, c = prefill(params, {
                "tokens": _tokens(req.prompt[None, :], dev)})
        width = -(-plen // P) * P if paged else total
        slc = fit(c, width)
        tok0 = torch.argmax(logits, -1).to(torch.int32)
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
        t0 = time.perf_counter()
        _wait(slc)                   # the arbiter's choice, NOT first-done
        stats["transfer_wait_s"] += time.perf_counter() - t0
        occ = arb.admit(req)
        stats["max_wait_passes"] = max(stats["max_wait_passes"], req.skips)
        if paged:
            n_ship = -(-plen // P)
            idx = np.asarray([alloc_page() for _ in range(n_ship)], np.int32)
            pt[s, :n_ship] = idx
            cache = admit(cache, slc, idx)
        else:
            cache = admit(cache, slc, s)
        stats["admissions"] += 1
        slot_occ[s] = occ
        slot_reqobj[s] = req
        slot_pos[s] = plen
        slot_tok[s] = int(tok0.cpu()[0])
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
        batch = {"tokens": _tokens(slot_tok[:, None], dev),
                 "pos": _tokens(slot_pos, dev)}
        if paged:
            logits, cache = decode(params, cache, pt, batch)
        else:
            logits, cache = decode(params, cache, batch)
        stats["decode_steps"] += 1
        nxt = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
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
                    help="model-parallel degree (0 = auto; one device "
                         "serves at 1)")
    ap.add_argument("--preset", default="serve_sp", choices=PRESET_NAMES)
    ap.add_argument("--act-transport", default="bf16",
                    choices=list(step_lib.ACT_TRANSPORTS))
    ap.add_argument("--ragged", action="store_true",
                    help="serve a mixed-length batch (continuous batching)")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregate prefill and decode onto separate "
                         "meshes (comes with serving across ranks)")
    ap.add_argument("--cache-transfer", default="bf16",
                    choices=list(step_lib.CACHE_TRANSFERS),
                    help="wire format of the prefill->decode cache handoff")
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
    if args.disagg:
        raise _multi_device("--disagg")
    if args.tp > 1:
        raise _multi_device(f"--tp {args.tp}")
    device = resolve_device(args.device, "launch.serve")
    mesh = make_local_mesh(device=device)

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

    fan_in = args.workers > 1 or args.paged
    t0 = time.time()
    out = generate(cfg, params, prompts, max_new=args.max_new,
                   temperature=args.temperature, prompt_lens=lens,
                   mesh=mesh, act_transport=args.act_transport,
                   cache_transfer=args.cache_transfer,
                   kv_storage=args.kv_storage,
                   stream=args.stream, slots=args.slots,
                   workers=args.workers, evict=args.evict,
                   paged=args.paged, page_size=args.page_size,
                   pool_pages=args.pool_pages, horizon=args.horizon,
                   priorities=prios)
    dt = time.time() - t0
    n_tok = out.size
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"prompt={args.prompt_len} new={args.max_new} "
          f"mesh={mesh.shape} "
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
