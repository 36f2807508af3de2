"""Granite-4.0-H-Small as the port runs it (family ``hybrid_moe``), and
its weights drawn on the device from the seed.

The weights are the benchmark's input: drawn here, in the tree layout the
port declares (``repro_torch.models.transformer.abstract_params``, checked
against it), and handed to the program and to the reference alike.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch


def attn_layers(cfg: Dict[str, Any]) -> tuple:
    """The indices of the attention layers in ``layer_types``."""
    kinds = cfg["layer_types"]
    if len(kinds) != cfg["num_hidden_layers"] \
            or set(kinds) - {"mamba", "attention"}:
        raise ValueError(f"layer_types must name mamba or attention for "
                         f"each of {cfg['num_hidden_layers']} layers")
    return tuple(i for i, k in enumerate(kinds) if k == "attention")


def port_config(cfg: Dict[str, Any]):
    """The port's ``HybridMoEConfig`` for a configuration file's keys
    (HF's ``config.json`` names)."""
    from repro_torch.configs import HybridMoEConfig

    if cfg["position_embedding_type"] != "nope" or cfg["attention_bias"] \
            or not cfg["mamba_conv_bias"] or cfg["mamba_proj_bias"] \
            or cfg["hidden_act"] != "silu" \
            or cfg["normalization_function"] != "rmsnorm":
        raise ValueError("the port runs NoPE attention without bias, a "
                         "conv with bias, projections without bias, SiLU "
                         "and RMSNorm")
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return HybridMoEConfig(
        name=cfg["name"], family="hybrid_moe",
        n_layers=cfg["num_hidden_layers"], d_model=d, n_heads=h,
        n_kv_heads=cfg["num_key_value_heads"], d_ff=0,
        vocab=cfg["vocab_size"], head_dim=d // h,
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]),
        n_experts=cfg["num_local_experts"],
        top_k=cfg["num_experts_per_tok"],
        d_ff_expert=cfg["intermediate_size"],
        d_ff_shared=cfg["shared_intermediate_size"],
        attn_layers=attn_layers(cfg),
        ssm_state=cfg["mamba_d_state"], ssm_expand=cfg["mamba_expand"],
        ssm_conv=cfg["mamba_d_conv"], mamba_heads=cfg["mamba_n_heads"],
        mamba_head_dim=cfg["mamba_d_head"],
        mamba_groups=cfg["mamba_n_groups"],
        mamba_chunk=cfg["mamba_chunk_size"],
        embedding_multiplier=float(cfg["embedding_multiplier"]),
        attention_multiplier=float(cfg["attention_multiplier"]),
        residual_multiplier=float(cfg["residual_multiplier"]),
        logits_scaling=float(cfg["logits_scaling"]), nope=True)


def leaf_shapes(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The weight tree's shapes: ``layers`` (the Mamba-2 layers) beside
    ``attn_layers`` (the attention layers), each with its MoE."""
    na = len(attn_layers(cfg))
    nm = cfg["num_hidden_layers"] - na
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    di = cfg["mamba_expand"] * d
    heads = cfg["mamba_n_heads"]
    cd = di + 2 * cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    e, fe = cfg["num_local_experts"], cfg["intermediate_size"]
    fs = cfg["shared_intermediate_size"]

    def moe(n):
        return {"router": (n, d, e), "w_gate": (n, e, d, fe),
                "w_up": (n, e, d, fe), "w_down": (n, e, fe, d),
                "shared_gate": (n, d, fs), "shared_up": (n, d, fs),
                "shared_down": (n, fs, d)}
    return {"embed": (v, d), "final_norm": (d,),
            "layers": {"ln1": (nm, d), "ln2": (nm, d),
                       "ssm": {"in_proj": (nm, d, di + cd + heads),
                               "conv_w": (nm, cfg["mamba_d_conv"], cd),
                               "conv_b": (nm, cd), "dt_bias": (nm, heads),
                               "a_log": (nm, heads), "d_skip": (nm, heads),
                               "norm": (nm, di), "out_proj": (nm, di, d)},
                       "moe": moe(nm)},
            "attn_layers": {"ln1": (na, d), "ln2": (na, d),
                            "attn": {"wq": (na, d, h, hd),
                                     "wk": (na, d, hkv, hd),
                                     "wv": (na, d, hkv, hd),
                                     "wo": (na, h, hd, d)},
                            "moe": moe(na)}}


ONES = ("final_norm", "ln1", "ln2", "norm", "d_skip")
F32 = ("router", "dt_bias", "a_log", "d_skip")
# the projections back into the residual stream
OUT = ("wo", "out_proj", "w_down", "shared_down")


def _stds(cfg: Dict[str, Any]) -> Dict[str, float]:
    """Each matrix's standard deviation, 1/sqrt(its fan-in within one
    layer), times ``init.out_gain`` for the projections back into the
    residual stream; the embedding's from ``init.embed_std``."""
    d = cfg["hidden_size"]
    di = cfg["mamba_expand"] * d
    gain = float(cfg["init"]["out_gain"])
    hq = cfg["num_attention_heads"] * (d // cfg["num_attention_heads"])
    std = {"embed": float(cfg["init"]["embed_std"]),
           "wq": d ** -0.5, "wk": d ** -0.5, "wv": d ** -0.5,
           "wo": hq ** -0.5,
           "in_proj": d ** -0.5, "conv_w": cfg["mamba_d_conv"] ** -0.5,
           "conv_b": cfg["mamba_d_conv"] ** -0.5, "out_proj": di ** -0.5,
           "router": d ** -0.5, "w_gate": d ** -0.5, "w_up": d ** -0.5,
           "w_down": cfg["intermediate_size"] ** -0.5,
           "shared_gate": d ** -0.5, "shared_up": d ** -0.5,
           "shared_down": cfg["shared_intermediate_size"] ** -0.5}
    for k in OUT:
        std[k] *= gain
    return std


def draw_weights(cfg: Dict[str, Any], seed: int, device,
                 dtype=torch.bfloat16) -> Dict[str, Any]:
    """The weights from ``seed``: one draw per leaf by a generator on
    ``device``, in ``dtype`` (the router, A_log, dt_bias and D in
    float32); norm scales and D are ones, A_log and dt_bias Mamba-2's
    reference initialisation (A uniform in [1, 16], dt log-uniform in
    [0.001, 0.1])."""
    gen = torch.Generator(device).manual_seed(int(seed) % (1 << 63))
    stds = _stds(cfg)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) \
            * (hi - lo) + lo

    def draw(name, shape):
        dt = torch.float32 if name in F32 else dtype
        if name in ONES:
            return torch.ones(shape, dtype=dt, device=device)
        if name == "a_log":
            return torch.log(uniform(shape, 1.0, 16.0))
        if name == "dt_bias":
            step = torch.exp(uniform(shape, math.log(1e-3), math.log(0.1)))
            step = step.clamp_min(1e-4)
            return step + torch.log(-torch.expm1(-step))   # softplus^-1
        t = torch.randn(shape, generator=gen, dtype=dt, device=device)
        return t.mul_(stds[name])

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else draw(k, v)
                for k, v in tree.items()}
    return walk(leaf_shapes(cfg))


def check_layout(cfg: Dict[str, Any], weights: Dict[str, Any]) -> None:
    """Refuses weights whose tree, shapes or float32 leaves differ from
    what the port declares."""
    from repro_torch.models import transformer

    want = transformer.abstract_params(port_config(cfg))

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        return tuple(tree.shape), tree.dtype == torch.float32
    if layout(want) != layout(weights):
        raise ValueError(f"weight layout {layout(weights)} is not the "
                         f"port's {layout(want)}")
