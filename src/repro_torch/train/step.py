"""The train step: microbatched gradients, the gradient transport, AdamW.

The port of the train half of ``src/repro/train/step.py`` (lines 1-127).
Gradients come from autograd over the tree's leaves. The step runs where
the parameters are and returns new trees, as the reference's does.

Waiting for later slices: the explicit data-parallel step
(``mesh=<...>``, the reference's ``_data_parallel_step``) for the
multi-GPU slice, ROADMAP queue 1, item 3; the serve steps (prefill, decode,
encode) for single-device serving.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import ModelConfig
from repro_torch.dist import collectives
from repro_torch.models import transformer
from repro_torch.models.common import (tree_leaves, tree_map,
                                       tree_unflatten, tree_unzip)
from repro_torch.train import optimizer as opt_lib

GRAD_TRANSPORTS = ("bf16", "int8_ef")


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
