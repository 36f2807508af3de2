"""The yardstick's arithmetic for a latent-attention MoE model
(DeepSeek-V2's block), from the configuration file's keys: the operations
the decode steps need, at the card's peak of ``_work``.

Attention counts MLA in its absorbed form, the least work it needs: per
token and head, the query's nope dims taken into the latent (kv_lora x
nope) and the attended latent out to the value dims (kv_lora x v); per
key and head, kv_lora + rope dims for the score and kv_lora for the
weighted sum. An MoE layer counts its router, its ``num_experts_per_tok``
routed experts and its shared experts; each leading dense layer its
SwiGLU. So no implementation can read above the peak.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple


def attn_params(cfg: Dict) -> int:
    """Weights one token's projections multiply in one layer, the
    absorption products included."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    rq, rkv = cfg["q_lora_rank"] or 0, cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], \
        cfg["v_head_dim"]
    q = d * rq + rq * h * (dn + dr) if rq else d * h * (dn + dr)
    return q + d * (rkv + dr) + h * dn * rkv + h * rkv * dv + h * dv * d


def ffn_params(cfg: Dict, moe: bool) -> int:
    """Weights one token's FFN multiplies in one layer: the router, the
    chosen and the shared experts, or the dense SwiGLU."""
    d = cfg["hidden_size"]
    if not moe:
        return 3 * d * cfg["intermediate_size"]
    fe = cfg["moe_intermediate_size"]
    used = cfg["num_experts_per_tok"] + cfg["n_shared_experts"]
    return d * cfg["n_routed_experts"] + 3 * d * fe * used


def token_params(cfg: Dict) -> int:
    """Weights one decoded token multiplies: every layer and the head."""
    nd = cfg["first_k_dense_replace"]
    nm = cfg["num_hidden_layers"] - nd
    return cfg["num_hidden_layers"] * attn_params(cfg) \
        + nd * ffn_params(cfg, False) + nm * ffn_params(cfg, True) \
        + cfg["hidden_size"] * cfg["vocab_size"]


def _key(cfg: Dict) -> int:
    """FLOPs of one query against one key in every layer."""
    rkv, dr = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    return 2 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] \
        * (2 * rkv + dr)


def decode_flops(cfg: Dict, keys: int) -> int:
    """One decoded token that attends ``keys`` positions, itself
    included, and its logits."""
    return 2 * token_params(cfg) + _key(cfg) * keys


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
