"""The yardstick's arithmetic for a Mamba-2 and attention hybrid with
experts (Granite-4.0-H's block), from the configuration file's keys: the
operations the decode steps need, at the card's peak of ``_work``.

A Mamba-2 layer counts its projections, its conv over x, B and C, and the
recurrence's update and readout, 4 x heads x head dim x state; an
attention layer its projections and its attention over the live context;
every layer its router, its ``num_experts_per_tok`` routed experts and
its shared expert; and the head once. So no implementation can read above
the peak.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple


def _kinds(cfg: Dict) -> Tuple[int, int]:
    """(Mamba-2 layers, attention layers)."""
    na = sum(1 for k in cfg["layer_types"] if k == "attention")
    return cfg["num_hidden_layers"] - na, na


def mamba_flops(cfg: Dict) -> int:
    """One token through one Mamba-2 layer."""
    d, heads = cfg["hidden_size"], cfg["mamba_n_heads"]
    di = cfg["mamba_expand"] * d
    cd = di + 2 * cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    proj = 2 * d * (di + cd + heads) + 2 * di * d
    conv = 2 * cfg["mamba_d_conv"] * cd
    return proj + conv + 4 * heads * cfg["mamba_d_head"] \
        * cfg["mamba_d_state"]


def attn_proj_flops(cfg: Dict) -> int:
    """One token's q, k, v and output projections in one attention
    layer."""
    d, h, hkv = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    hd = d // h
    return 2 * (2 * d * h * hd + 2 * d * hkv * hd)


def moe_flops(cfg: Dict) -> int:
    """One token's router, chosen experts and shared expert."""
    d = cfg["hidden_size"]
    return 2 * d * cfg["num_local_experts"] \
        + 6 * d * (cfg["num_experts_per_tok"] * cfg["intermediate_size"]
                   + cfg["shared_intermediate_size"])


def _key(cfg: Dict) -> int:
    """FLOPs of one query against one key in every attention layer."""
    return 4 * _kinds(cfg)[1] * cfg["hidden_size"]


def decode_flops(cfg: Dict, keys: int) -> int:
    """One decoded token that attends ``keys`` positions, itself
    included, and its logits."""
    nm, na = _kinds(cfg)
    return nm * mamba_flops(cfg) + na * attn_proj_flops(cfg) \
        + cfg["num_hidden_layers"] * moe_flops(cfg) \
        + 2 * cfg["hidden_size"] * cfg["vocab_size"] + _key(cfg) * keys


def decoded_flops(cfg: Dict, requests: Iterable[Tuple[int, int]]) -> int:
    """The decode steps of requests of (prompt length, new tokens): the
    prefill gives the first token, each later one a decode step at the
    next position; the prefills are not counted."""
    total = 0
    for n, new in requests:
        # tokens 2..new at positions n .. n + new - 2 attend n+1 .. n+new-1
        m = new - 1
        total += m * decode_flops(cfg, 0) \
            + _key(cfg) * (m * n + m * (m + 1) // 2)
    return total
