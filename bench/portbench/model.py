"""A dense configuration as the port runs it, and its weights drawn on the
device from the seed.

The weights are the benchmark's input: drawn here, in the tree layout the
port's dense stack takes (``repro_torch.models.transformer.param_specs``,
checked against it), and handed to the program and to the reference alike.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def port_config(cfg: Dict[str, Any]):
    """The port's ``ModelConfig`` for a configuration file's keys."""
    from repro_torch.configs import ModelConfig

    return ModelConfig(
        name=cfg["name"], family="dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        head_dim=cfg["head_dim"],
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]))


def leaf_shapes(cfg: Dict[str, Any]) -> Dict[str, Any]:
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, f, v = cfg["head_dim"], cfg["intermediate_size"], cfg["vocab_size"]
    return {"embed": (v, d), "final_norm": (d,),
            "layers": {"ln1": (L, d), "ln2": (L, d),
                       "attn": {"wq": (L, d, h, hd), "wk": (L, d, hkv, hd),
                                "wv": (L, d, hkv, hd), "wo": (L, h, hd, d)},
                       "mlp": {"gate": (L, d, f), "up": (L, d, f),
                               "down": (L, f, d)}}}


def _stds(cfg: Dict[str, Any]) -> Dict[str, float]:
    """Each leaf's standard deviation: 1/sqrt(fan-in) of one layer's
    matrix, and the embedding's from the configuration's ``init`` (it
    sets the spread of the tied logits)."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    hq = cfg["num_attention_heads"] * cfg["head_dim"]
    return {"embed": float(cfg["init"]["embed_std"]),
            "wq": d ** -0.5, "wk": d ** -0.5, "wv": d ** -0.5,
            "wo": hq ** -0.5, "gate": d ** -0.5, "up": d ** -0.5,
            "down": f ** -0.5}


def draw_weights(cfg: Dict[str, Any], seed: int, device,
                 dtype=torch.bfloat16) -> Dict[str, Any]:
    """The weights from ``seed``: one normal draw per leaf by a generator
    on ``device``, in ``dtype``; norm scales are ones."""
    gen = torch.Generator(device).manual_seed(int(seed) % (1 << 63))
    stds = _stds(cfg)

    def draw(name, shape):
        if name in ("final_norm", "ln1", "ln2"):
            return torch.ones(shape, dtype=dtype, device=device)
        t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return t.mul_(stds[name])

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else draw(k, v)
                for k, v in tree.items()}
    return walk(leaf_shapes(cfg))


def check_layout(cfg: Dict[str, Any], weights: Dict[str, Any]) -> None:
    """Refuses weights whose tree differs from what the port declares."""
    from repro_torch.models import transformer

    want = transformer.abstract_params(port_config(cfg))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)
    if shapes(want) != shapes(weights):
        raise ValueError(f"weight layout {shapes(weights)} is not the "
                         f"port's {shapes(want)}")

