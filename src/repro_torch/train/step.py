"""Step factories: the train step (microbatched gradients, the gradient
transport, AdamW) and the serve steps (encode, prefill, decode).

The port of ``src/repro/train/step.py``. Gradients come from autograd over
the tree's leaves. Each step runs where the parameters are and returns new
trees, as the reference's does. The serve steps enter the activation
transport and KV storage scopes around every call and run under
``torch.no_grad()`` (not ``inference_mode``, whose tensors a DTensor
cannot carry).

The train step has three forms, as in the reference:

- one device (``mesh=None`` outside any ``DeviceMesh`` context);
- the explicit data-parallel step (``mesh=<DeviceMesh>``, the reference's
  ``_data_parallel_step``): parameters and moments replicated, each rank
  on its rows of the global batch, the gradient reduction explicit (a
  bf16 ``all_reduce`` or the two-stage int8 exchange), so the bytes on
  the wire are the transport's;
- the SPMD step (``mesh=None`` inside ``sharding.axis_rules(<DeviceMesh>,
  rules)``, the launcher's form): parameters and moments are DTensors
  laid out by the rules, the batch ``Shard(0)`` over data, the model's
  ops run on DTensors, and each gradient is redistributed to its
  parameter's placements before AdamW.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.dist import collectives
from repro_torch.dist import sharding
from repro_torch.models import registry as model_registry
from repro_torch.models import transformer
from repro_torch.models.common import (repeated, tree_leaves, tree_map,
                                       tree_unflatten, tree_unzip)
from repro_torch.train import optimizer as opt_lib

GRAD_TRANSPORTS = ("bf16", "int8_ef")
ACT_TRANSPORTS = collectives.ACT_TRANSPORTS   # serve steps: ("bf16", "int8")
KV_STORAGES = collectives.KV_STORAGES         # decode cache residency
CACHE_TRANSFERS = collectives.CACHE_TRANSFERS # prefill->decode handoff wire


def make_loss_fn(cfg: ModelConfig):
    model_registry.require(cfg, "trains", "training")

    def loss_fn(params, batch):
        loss, metrics = transformer.forward(cfg, params, batch, "train")
        return loss, metrics
    return loss_fn


def _split_microbatches(batch: Dict[str, Any], n_mb: int) -> Dict[str, Any]:
    def split(x):
        b = x.shape[0]
        assert b % n_mb == 0, (b, n_mb)
        return x.reshape(n_mb, b // n_mb, *x.shape[1:])
    return {k: split(v) for k, v in batch.items()}


def _microbatches(batch: Dict[str, Any], n_mb: int) -> list:
    """``batch`` as ``n_mb`` dicts of consecutive row blocks."""
    mb = _split_microbatches(batch, n_mb)
    return [{k: v[i] for k, v in mb.items()} for i in range(n_mb)]


def _int8_ef_transport(grads, opt_state, axis_name, block, mesh=None):
    """Per-leaf int8 + error-feedback reduction; the residual lives in
    ``opt_state["ef"]`` (a ``KeyError`` when the state has none)."""
    def leaf(g, e):
        if not sharding.is_dtensor(g):
            return collectives.compressed_psum(g, axis_name, e, block=block,
                                               mesh=mesh)
        # an SPMD leaf: each rank quantizes its shard where the shard is a
        # run of whole blocks of the leaf's flattened elements, so its
        # blocks are the one-device step's; a dim whose shards cut a block
        # is gathered first, that dim only
        place = _whole_block_placements(g, block)
        gl = collectives.redistribute("int8_ef_gather", g, place)
        el = collectives.redistribute("int8_ef_gather", e, place)
        out, new_e = collectives.compressed_psum(
            gl.to_local(), None, el.to_local(), block=block)
        return (_lay_out_as(collectives.from_local(out, gl), g),
                _lay_out_as(collectives.from_local(new_e, el), e))

    out = tree_map(leaf, grads, opt_state["ef"])
    new_grads, new_ef = tree_unzip(out, 2)
    return new_grads, {**opt_state, "ef": new_ef}


def make_train_step(cfg: ModelConfig, adamw: opt_lib.AdamWConfig,
                    microbatches: int = 1, grad_transport: str = "bf16",
                    mesh=None, data_axis: str = "data", ef_block: int = 256):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``.

    With ``microbatches > 1`` the batch is split along its first axis;
    each microbatch's gradients are summed in f32 and the sum divided by
    ``microbatches``, then cast to bf16 when the transport is ``"bf16"``;
    the metrics are the last microbatch's, with ``loss`` their mean. With
    one microbatch the gradients keep the parameters' dtype.

    ``grad_transport``: ``"bf16"``, the baseline, or ``"int8_ef"``,
    blockwise int8 with error feedback (``collectives.compressed_psum``)
    whose residual rides in ``opt_state["ef"]``; build that state with
    ``opt_lib.init_state(params, error_feedback=True)``.

    ``mesh=<DeviceMesh>`` gives the explicit data-parallel step over
    ``data_axis`` (see :func:`_data_parallel_step`). With ``mesh=None``
    inside ``sharding.axis_rules(<DeviceMesh>, rules)`` the step is the
    SPMD step over that context (see :func:`_spmd_step`); elsewhere it is
    the one-device step.
    """
    if grad_transport not in GRAD_TRANSPORTS:
        raise ValueError(f"unknown grad_transport {grad_transport!r}; "
                         f"expected one of {GRAD_TRANSPORTS}")
    loss_fn = make_loss_fn(cfg)

    @repeated
    def grad_fn(params, batch):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None
                 else _to_param_layout(g, t) for t, g in zip(leaves, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def grads_and_metrics(params, batch, split=_microbatches):
        mbs = split(batch, microbatches)
        if microbatches > 1:
            gsum, lsum, metrics = None, 0.0, None
            for mb in mbs:
                loss, metrics, grads = grad_fn(params, mb)
                grads = [g.float() for g in grads]
                gsum = grads if gsum is None else \
                    [a + g for a, g in zip(gsum, grads)]
                lsum = lsum + loss
            grads = [g / microbatches for g in gsum]
            if grad_transport == "bf16":
                grads = [g.to(torch.bfloat16) for g in grads]
            metrics["loss"] = lsum / microbatches
        else:
            _, metrics, grads = grad_fn(params, mbs[0])
        return tree_unflatten(params, grads), metrics

    def train_step(params, opt_state, batch, split=_microbatches):
        grads, metrics = grads_and_metrics(params, batch, split)
        if grad_transport == "int8_ef":
            grads, opt_state = _int8_ef_transport(grads, opt_state, None,
                                                  ef_block)
        new_params, new_opt, opt_metrics = opt_lib.apply_updates(
            adamw, params, grads, opt_state)
        metrics.update(opt_metrics)
        return new_params, new_opt, metrics

    if mesh is not None:
        return _data_parallel_step(grads_and_metrics, adamw, mesh, data_axis,
                                   grad_transport, ef_block)
    active = sharding.current_context()
    if active is None or not sharding.is_device_mesh(active[0]):
        return train_step
    return _spmd_step(train_step, *active)


def _whole_block_placements(x, block: int) -> tuple:
    """Placements of DTensor ``x`` under which each rank's shard is a run
    of whole ``block``-element blocks of ``x``'s flattened elements (so
    quantizing it flat gives the blocks of quantizing ``x`` whole): ``x``'s
    own where they do, else with the innermost split dim made whole, one
    dim at a time. A shard of dim ``d`` is such a run when ``d`` and every
    split dim splits evenly and its rows times the elements after ``d``
    fill whole blocks."""
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    place = list(x.placements)
    while True:
        split: Dict[int, int] = {}
        for m, p in enumerate(place):
            if p.is_shard():
                d = p.dim % x.ndim
                split[d] = split.get(d, 1) * mesh.size(m)
        if not split:
            return tuple(place)
        d = max(split)
        inner = 1
        for n in x.shape[d + 1:]:
            inner *= n
        even = all(x.shape[k] % n == 0 for k, n in split.items())
        if even and (x.shape[d] // split[d]) * inner % block == 0:
            return tuple(place)
        place = [Replicate() if p.is_shard() and p.dim % x.ndim == d else p
                 for p in place]


def _lay_out_as(x, like) -> Any:
    """DTensor ``x``, whose layout splits no dim that ``like``'s does not,
    laid out as ``like``: each rank keeps a copy of its shard (a local
    slice, nothing moves), and the larger shard is freed (a view would
    keep it)."""
    from torch.distributed.tensor import DTensor

    if tuple(x.placements) != tuple(like.placements):
        x = x.redistribute(like.device_mesh, like.placements)
    return DTensor.from_local(x.to_local().clone(), like.device_mesh,
                              like.placements, shape=like.shape,
                              stride=like.stride())


def _to_param_layout(g, t):
    """A DTensor gradient redistributed to its parameter's placements
    (a reduce-scatter or all-reduce of the partial sums); a plain one as
    it is."""
    if sharding.is_dtensor(g) and tuple(g.placements) != tuple(t.placements):
        return g.redistribute(t.device_mesh, t.placements)
    return g


def _rows(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rows ``[rank * B / world, (rank + 1) * B / world)`` of ``x``."""
    b = x.shape[0]
    if b % world:
        raise ValueError(f"a batch of {b} rows does not split over "
                         f"{world} ranks")
    return x[rank * b // world:(rank + 1) * b // world]


def _data_parallel_step(grads_and_metrics, adamw, mesh, data_axis,
                        grad_transport, ef_block):
    """The explicit data-parallel step over ``data_axis`` of ``mesh``.

    Every rank passes the same global batch and takes its rows; its
    gradients are those of the mean loss over its rows, divided by the
    axis size ``W`` in f32 before the reduction: a bf16 ``all_reduce``,
    or under ``int8_ef`` the two-stage int8 exchange, whose residual is
    this rank's ``(1, *shape)`` row of ``opt_state["ef"]`` (build the
    state with ``init_state(params, error_feedback=True,
    ef_devices=1)``). The metrics are averaged over the axis in one f32
    ``all_reduce``; the parameters and moments stay replicated. A
    checkpoint of this state holds the saving rank's residual row.
    """
    group = collectives.axis_group(data_axis, mesh)
    w = sharding.axis_sizes(mesh)[data_axis]
    rank = 0 if group is None else torch.distributed.get_rank(group)

    def device_step(params, opt_state, batch):
        local = {k: _rows(v, rank, w) for k, v in batch.items()}
        grads, metrics = grads_and_metrics(params, local)
        grads = tree_map(lambda g: g.float() / w, grads)
        if grad_transport == "bf16":
            grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
            if group is not None:
                grads = tree_map(
                    lambda g: collectives.all_reduce(g, group), grads)
        else:
            row = {**opt_state, "ef": tree_map(lambda e: e[0],
                                               opt_state["ef"])}
            grads, row = _int8_ef_transport(grads, row, data_axis,
                                            ef_block, mesh)
            opt_state = {**opt_state,
                         "ef": tree_map(lambda e: e[None], row["ef"])}
        names = sorted(metrics)
        stacked = torch.stack([metrics[k].float() for k in names])
        if group is not None:
            stacked = collectives.all_reduce(stacked, group)
        metrics = dict(zip(names, stacked / w))
        new_params, new_opt, opt_metrics = opt_lib.apply_updates(
            adamw, params, grads, opt_state)
        metrics.update(opt_metrics)
        return new_params, new_opt, metrics

    return device_step


def _spmd_step(train_step, mesh, rules):
    """The SPMD step over ``mesh`` under ``rules``.

    The parameters and the optimizer state are DTensors (lay them out with
    ``sharding.distribute_tree(tree, axes, mesh, rules)``, the moments by
    ``optimizer.state_axes``). Every rank passes the same global batch,
    splits it into microbatches of consecutive rows, as the one-device
    step does, and enters its rows of each microbatch as ``Shard(0)`` over
    the batch axes: microbatch ``i`` holds the same rows on every mesh,
    and so do the last microbatch's metrics. The model runs on
    DTensors under the rules (``axis_rules`` reads plain tensors as
    replicated); under ``int8_ef`` each rank quantizes its shard of each
    gradient and residual, in the one-device step's blocks
    (:func:`_whole_block_placements`). The metrics come back as plain
    tensors.
    """
    from torch.distributed.tensor import DTensor

    names = list(mesh.mesh_dim_names)

    def enter(global_batch: Dict[str, Any], n_mb: int) -> list:
        rows = next(iter(global_batch.values())).shape[0] // n_mb
        spec = sharding.resolve_spec((rows,), ("batch",), mesh, rules)
        axes = spec[0] if spec else ()
        axes = axes if isinstance(axes, tuple) else (axes,)
        shards, coord = 1, 0
        for a in axes:       # this rank's shard index, major to minor
            size = mesh.size(names.index(a))
            coord = coord * size + mesh.get_local_rank(a)
            shards *= size
        place = sharding.placements(spec, mesh)
        return [{k: DTensor.from_local(_rows(v, coord, shards), mesh, place)
                 for k, v in mb.items()}
                for mb in _microbatches(global_batch, n_mb)]

    def spmd_step(params, opt_state, batch):
        with sharding.axis_rules(mesh, rules):
            new_params, new_opt, metrics = train_step(
                params, opt_state, batch, split=enter)
        return new_params, new_opt, {
            k: v.full_tensor() if sharding.is_dtensor(v) else v
            for k, v in metrics.items()}

    return spmd_step


def _check_act_transport(act_transport: Optional[str]) -> None:
    if act_transport is not None and act_transport not in ACT_TRANSPORTS:
        raise ValueError(f"unknown act_transport {act_transport!r}; "
                         f"expected one of {ACT_TRANSPORTS}")


def make_encode_step(cfg: ModelConfig, act_transport: Optional[str] = "bf16"):
    """Encoder-only serving: full-sequence unit logits (HuBERT-style)."""
    _check_act_transport(act_transport)

    @torch.no_grad()
    def encode_step(params, batch):
        with collectives.act_transport_scope(act_transport):
            logits, _ = transformer.forward(cfg, params, batch, "encode")
        return logits
    return encode_step


def make_prefill_step(cfg: ModelConfig, act_transport: Optional[str] = "bf16"):
    """Returns ``prefill_step(params, batch) -> (last-position logits,
    cache)``.

    ``batch`` may carry ``"last_pos"`` (per-row index of the final prompt
    token) for ragged continuous batching; without it the logits come from
    the last sequence position of every row. ``act_transport`` picks the
    activation all-gather's wire format: ``"bf16"``, ``"int8"`` (the
    activations rounded through blockwise int8 and back, no error
    feedback) or ``None`` (no gather boundary).
    """
    _check_act_transport(act_transport)

    @torch.no_grad()
    def prefill_step(params, batch):
        with collectives.act_transport_scope(act_transport):
            logits, cache = transformer.forward(cfg, params, batch, "prefill")
        return logits, cache
    return prefill_step


def make_decode_step(cfg: ModelConfig, cache_len_total: int,
                     act_transport: Optional[str] = "bf16",
                     kv_storage: str = "bf16"):
    """Returns ``decode_step(params, cache, batch) -> (logits, new_cache)``.

    ``batch["pos"]`` is a scalar position or a per-row ``(B,)`` vector
    (ragged continuous batching). ``kv_storage="int8"`` makes the cache
    int8-resident: the step expects and emits the layout of
    ``transformer.abstract_cache(..., kv_storage="int8")`` (s8 value
    leaves plus f32 ``<leaf>_scale`` leaves), writes each new token
    quantized per position, and attention dequantizes per block at read
    time; ``"f8"`` stores scale-free e4m3 leaves instead.
    """
    _check_act_transport(act_transport)
    if kv_storage not in KV_STORAGES:
        raise ValueError(f"unknown kv_storage {kv_storage!r}; "
                         f"expected one of {KV_STORAGES}")
    if kv_storage != "bf16":
        model_registry.require(cfg, "quantized_storage",
                               f"kv_storage={kv_storage!r}")

    @torch.no_grad()
    def decode_step(params, cache, batch):
        with collectives.act_transport_scope(act_transport), \
                collectives.kv_storage_scope(kv_storage):
            logits, new_cache = transformer.forward(
                cfg, params, batch, "decode", cache=cache,
                cache_len_total=cache_len_total)
        return logits, new_cache
    return decode_step


def step_for_shape(cfg: ModelConfig, shape: ShapeSpec,
                   adamw: Optional[opt_lib.AdamWConfig] = None,
                   grad_transport: str = "bf16",
                   act_transport: str = "bf16",
                   kv_storage: str = "bf16"):
    """The step for a given cell, plus its kind."""
    if shape.kind == "train":
        return make_train_step(cfg, adamw or opt_lib.AdamWConfig(),
                               microbatches=shape.microbatches,
                               grad_transport=grad_transport), "train"
    if shape.kind == "prefill":
        if not cfg.supports_decode:      # encoder: no cache semantics
            return make_encode_step(cfg, act_transport), "encode"
        return make_prefill_step(cfg, act_transport), "prefill"
    return make_decode_step(cfg, shape.seq_len, act_transport,
                            kv_storage), "decode"
