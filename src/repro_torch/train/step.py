"""Step factories: the train step (microbatched gradients, the gradient
transport, AdamW) and the serve steps (encode, prefill, decode).

The port of ``src/repro/train/step.py``. Gradients come from autograd over
the tree's leaves. Each step runs where the parameters are and returns new
trees, as the reference's does. The serve steps enter the activation
transport and KV storage scopes around every call and run under
``torch.inference_mode()``.

Waiting for the multi-GPU slice (ROADMAP queue 1, item 3): the explicit
data-parallel step (``mesh=<...>``, the reference's
``_data_parallel_step``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.dist import collectives
from repro_torch.models import registry as model_registry
from repro_torch.models import transformer
from repro_torch.models.common import (tree_leaves, tree_map,
                                       tree_unflatten, tree_unzip)
from repro_torch.train import optimizer as opt_lib

GRAD_TRANSPORTS = ("bf16", "int8_ef")
ACT_TRANSPORTS = collectives.ACT_TRANSPORTS   # serve steps: ("bf16", "int8")
KV_STORAGES = collectives.KV_STORAGES         # decode cache residency
CACHE_TRANSFERS = collectives.CACHE_TRANSFERS # prefill->decode handoff wire


def make_loss_fn(cfg: ModelConfig):
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


def _int8_ef_transport(grads, opt_state, axis_name, block):
    """Per-leaf int8 + error-feedback reduction; the residual lives in
    ``opt_state["ef"]`` (a ``KeyError`` when the state has none)."""
    out = tree_map(
        lambda g, e: collectives.compressed_psum(g, axis_name, e, block=block),
        grads, opt_state["ef"])
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
    """
    if grad_transport not in GRAD_TRANSPORTS:
        raise ValueError(f"unknown grad_transport {grad_transport!r}; "
                         f"expected one of {GRAD_TRANSPORTS}")
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step(mesh=...): the explicit data-parallel step "
            "comes with the multi-GPU slice (ROADMAP queue 1, item 3); on one "
            "device pass mesh=None")
    loss_fn = make_loss_fn(cfg)

    def grad_fn(params, batch):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def grads_and_metrics(params, batch):
        if microbatches > 1:
            mb = _split_microbatches(batch, microbatches)
            gsum, lsum, metrics = None, 0.0, None
            for i in range(microbatches):
                loss, metrics, grads = grad_fn(
                    params, {k: v[i] for k, v in mb.items()})
                grads = [g.float() for g in grads]
                gsum = grads if gsum is None else \
                    [a + g for a, g in zip(gsum, grads)]
                lsum = lsum + loss
            grads = [g / microbatches for g in gsum]
            if grad_transport == "bf16":
                grads = [g.to(torch.bfloat16) for g in grads]
            metrics["loss"] = lsum / microbatches
        else:
            _, metrics, grads = grad_fn(params, batch)
        return tree_unflatten(params, grads), metrics

    def train_step(params, opt_state, batch):
        grads, metrics = grads_and_metrics(params, batch)
        if grad_transport == "int8_ef":
            grads, opt_state = _int8_ef_transport(grads, opt_state, None,
                                                  ef_block)
        new_params, new_opt, opt_metrics = opt_lib.apply_updates(
            adamw, params, grads, opt_state)
        metrics.update(opt_metrics)
        return new_params, new_opt, metrics

    return train_step


def _check_act_transport(act_transport: Optional[str]) -> None:
    if act_transport is not None and act_transport not in ACT_TRANSPORTS:
        raise ValueError(f"unknown act_transport {act_transport!r}; "
                         f"expected one of {ACT_TRANSPORTS}")


def make_encode_step(cfg: ModelConfig, act_transport: Optional[str] = "bf16"):
    """Encoder-only serving: full-sequence unit logits (HuBERT-style)."""
    _check_act_transport(act_transport)

    @torch.inference_mode()
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

    @torch.inference_mode()
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

    @torch.inference_mode()
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
