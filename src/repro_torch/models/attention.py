"""Attention layers: GQA (optional QKV bias, optional sliding window) and
MLA (Multi-head Latent Attention, MiniCPM3/DeepSeek-style).

The port of ``src/repro/models/attention.py``, training path. Each layer
exposes ``specs(cfg)`` (parameter declarations) and
``apply(cfg, p, x, mode, cache, pos)`` -> (out, new_cache). Only
``mode="train"`` runs here: the decode and prefill branches, their
caches and the paged read come with serving (ROADMAP queue 1, item 2).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.dist.sharding import constrain, mesh_axis_size
from repro_torch.models import common
from repro_torch.models.common import (
    Spec, apply_rope, blockwise_attention, einsum, require_train,
)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def gqa_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": Spec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": Spec((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Spec((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Spec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = Spec((h, hd), ("heads", "head_dim"), init="zeros")
        s["bk"] = Spec((hkv, hd), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = Spec((hkv, hd), ("kv_heads", "head_dim"), init="zeros")
    return s


def gqa_apply(cfg: ModelConfig, p, x: torch.Tensor, mode: str,
              cache: Optional[dict], pos, cache_len_total: int,
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    require_train(mode, "gqa_apply")
    b, s, _ = x.shape
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", x, p["wk"])
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)

    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    # TP > kv_heads: replicate KV across query-head groups so attention
    # activations stay head-sharded (MaxText-style KV replication).
    tp = mesh_axis_size("model")
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    if tp > 1 and h % tp == 0 and hkv % tp != 0:
        rep = h // hkv
        k = constrain(torch.repeat_interleave(k, rep, dim=2), "batch", None, "heads", None)
        v = constrain(torch.repeat_interleave(v, rep, dim=2), "batch", None, "heads", None)
    out = blockwise_attention(q, k, v, causal=cfg.causal,
                              window=cfg.attn_window)
    y = constrain(einsum("bshk,hkd->bsd", out, p["wo"]),
                  "batch", None, "act_embed")
    return y, None


# ---------------------------------------------------------------------------
# MLA (latent KV cache)
# ---------------------------------------------------------------------------

def mla_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d, h = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": Spec((d, rq), ("embed", "q_lora")),
        "wq_b": Spec((rq, h, dn + dr), ("q_lora", "heads", "head_dim")),
        "wkv_a": Spec((d, rkv + dr), ("embed", "kv_lora")),
        "wk_b": Spec((rkv, h, dn), ("kv_lora", "heads", "head_dim")),
        "wv_b": Spec((rkv, h, dv), ("kv_lora", "heads", "head_dim")),
        "wo": Spec((h, dv, d), ("heads", "head_dim", "embed")),
        "q_norm": Spec((rq,), ("q_lora",), init="ones"),
        "kv_norm": Spec((rkv,), ("kv_lora",), init="ones"),
    }


def _mla_qk(cfg, p, x, positions):
    """Project to per-head q (nope|rope) and latent kv. x:(B,S,d)."""
    dn = cfg.nope_head_dim
    cq = common.rms_norm(einsum("bsd,dr->bsr", x, p["wq_a"]), p["q_norm"],
                         cfg.norm_eps)
    q = einsum("bsr,rhk->bshk", cq, p["wq_b"])              # (B,S,H,dn+dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv = einsum("bsd,dr->bsr", x, p["wkv_a"])               # (B,S,rkv+dr)
    latent = common.rms_norm(kv[..., :cfg.kv_lora_rank], p["kv_norm"],
                             cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, cfg.kv_lora_rank:], positions,
                        cfg.rope_theta)[..., 0, :]          # (B,S,dr) shared
    return torch.cat([q_nope, q_rope], -1), latent, k_rope


def _mla_expand(cfg, p, latent, k_rope):
    """Expand latent into per-head K (nope|rope-shared) and V."""
    k_nope = einsum("bsr,rhk->bshk", latent, p["wk_b"])
    v = einsum("bsr,rhk->bshk", latent, p["wv_b"])
    kr = k_rope[:, :, None, :].expand(*k_nope.shape[:3], cfg.rope_head_dim)
    return torch.cat([k_nope, kr], -1), v


def mla_apply(cfg: ModelConfig, p, x, mode, cache, pos, cache_len_total):
    require_train(mode, "mla_apply")
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    q, latent, k_rope = _mla_qk(cfg, p, x, positions)
    k, v = _mla_expand(cfg, p, latent, k_rope)
    out = blockwise_attention(q, k, v, causal=cfg.causal)
    y = constrain(einsum("bshk,hkd->bsd", out, p["wo"]),
                  "batch", None, "act_embed")
    return y, None
