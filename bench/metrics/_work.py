"""The yardstick's arithmetic: the operations and bytes the work needs,
counted from the configuration and the sizes served, and the card's peaks.

Causal attention counts the query-key pairs it needs (query t sees t + 1
keys), not the tiles an implementation computes; a prefill counts one
logits row, decode one per token.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def layer_params(cfg: Dict) -> int:
    """Weights of one layer's matrices (norm scales left out)."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    hq = cfg["num_attention_heads"] * cfg["head_dim"]
    hkv = cfg["num_key_value_heads"] * cfg["head_dim"]
    return 2 * d * hq + 2 * d * hkv + 3 * d * f


def _attn(cfg: Dict) -> int:
    """FLOPs of one query against one key in every layer (scores and the
    weighted sum)."""
    return 4 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] \
        * cfg["head_dim"]


def prefill_flops(cfg: Dict, n: int) -> int:
    """A prompt of n tokens, and the logits of its last position."""
    lin = 2 * cfg["num_hidden_layers"] * layer_params(cfg) * n
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    return lin + head + _attn(cfg) * n * (n + 1) // 2


def decode_flops(cfg: Dict, keys: int) -> int:
    """One decoded token that attends ``keys`` positions, itself
    included, and its logits."""
    return 2 * cfg["num_hidden_layers"] * layer_params(cfg) \
        + 2 * cfg["hidden_size"] * cfg["vocab_size"] + _attn(cfg) * keys


def decoded_flops(cfg: Dict, requests: Iterable[Tuple[int, int]]) -> int:
    """The decode steps of requests of (prompt length, new tokens): the
    prefill gives the first token, each later one a decode step at the
    next position; the prefills are not counted."""
    total = 0
    for n, new in requests:
        # tokens 2..new at positions n .. n + new - 2 attend n+1 .. n+new-1
        m = new - 1
        total += m * decode_flops(cfg, 0) + _attn(cfg) * (m * n + m * (m + 1) // 2)
    return total
