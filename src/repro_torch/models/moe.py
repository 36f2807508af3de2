"""Dropped-token Mixture-of-Experts layer (Qwen3-MoE style: top-k softmax-
renormalized gates, no shared expert).

The port of ``src/repro/models/moe.py``. Tokens are processed in groups of
``GROUP`` tokens; each group dispatches into per-expert capacity buffers
with a deterministic einsum (Mesh-TensorFlow formulation). A choice's slot
in its expert's buffer is the count of earlier (token, choice) pairs of
the group routed there, so which choices are dropped depends on the group
size and on that order, both kept from the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.dist.collectives import current_act_transport
from repro_torch.dist.sharding import constrain
from repro_torch.kernels.expert_a2a import expert_a2a
from repro_torch.models.common import Spec, einsum

GROUP = 512  # tokens per dispatch group (upper bound)


def moe_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    return {
        "router": Spec((d, e), ("embed", "experts"), dtype=torch.float32),
        "w_gate": Spec((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_up": Spec((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_down": Spec((e, f, d), ("experts", "expert_mlp", "embed")),
    }


def _group_size(n_tokens: int) -> int:
    g = min(GROUP, n_tokens)
    while n_tokens % g:
        g -= 1
    return g


def capacity(cfg: ModelConfig, group: int) -> int:
    return max(1, math.ceil(cfg.capacity_factor * group * cfg.top_k / cfg.n_experts))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot``: f32, and all zeros for an index outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, in descending
    order, equal values in ascending index order. A stable descending sort
    gives that order on every device; ``torch.topk`` does not promise it."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor, mode: str = "train"
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (B, S, d), aux metrics (load-balance loss etc.).

    Train and prefill use the einsum dispatch. Decode under the int8
    activation transport routes the dispatch buffers through the
    ``expert_a2a`` op, as the reference does: under the "ep" preset on a
    mesh that boundary is the expert all-to-all, carrying s8 values and
    scales.
    """
    b, s, d = x.shape
    n_tokens = b * s
    m = _group_size(n_tokens)
    g = n_tokens // m
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(cfg, m)

    xt = constrain(x.reshape(g, m, d), "batch", None, "act_embed")
    logits = constrain(einsum("gmd,de->gme", xt.float(), p["router"]),
                       "batch", None, None)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, sel = top_k(probs, k)                             # (g,m,k)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)  # renorm (Qwen3)

    onehot = _one_hot(sel, e)                                    # (g,m,k,e)
    flat = onehot.reshape(g, m * k, e)
    # position of each (token, choice) within its expert's buffer
    pos_in_e = torch.cumsum(flat, dim=1) - flat                  # (g,mk,e)
    slot = torch.sum(pos_in_e * flat, dim=-1).to(torch.int32)    # (g,mk)
    keep = (slot < c).float().reshape(g, m, k)
    slot_oh = _one_hot(slot.reshape(g, m, k), c)

    # dispatch mask (g,m,e,c) and gate-weighted combine mask
    dispatch = constrain(
        einsum("gmke,gmkc->gmec", onehot * keep[..., None], slot_oh),
        "batch", None, "experts", None)
    combine = constrain(
        einsum("gmke,gmkc->gmec",
               onehot * (gate_vals * keep)[..., None], slot_oh),
        "batch", None, "experts", None)

    xe = einsum("gmec,gmd->gecd", dispatch.to(x.dtype), xt)     # (g,e,c,d)
    if mode == "decode" and current_act_transport() == "int8":
        xe = expert_a2a(xe)
    else:
        xe = constrain(xe, "batch", "experts", None, "act_embed")
    h_gate = constrain(einsum("gecd,edf->gecf", xe, p["w_gate"]),
                       "batch", "experts", None, None)
    h_up = einsum("gecd,edf->gecf", xe, p["w_up"])
    ye = constrain(einsum("gecf,efd->gecd",
                          F.silu(h_gate) * h_up, p["w_down"]),
                   "batch", "experts", None, "act_embed")
    y = constrain(einsum("gmec,gecd->gmd", combine.to(x.dtype), ye),
                  "batch", None, "act_embed")

    # aux: load-balance loss (Switch style) + router z-loss + drop fraction
    density = torch.mean(onehot, dim=(1, 2))                     # (g,e) selection freq
    density_prob = torch.mean(probs, dim=1)                      # (g,e)
    lb_loss = e * torch.mean(torch.sum(density * density_prob, dim=-1))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    dropped = 1.0 - torch.mean(keep)
    aux = {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss,
           "moe_drop_frac": dropped}
    return y.reshape(b, s, d), aux
