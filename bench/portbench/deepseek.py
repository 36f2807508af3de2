"""DeepSeek-V2-Lite as the port runs it (family ``mla_moe``), and its
weights drawn on the device from the seed.

The weights are the benchmark's input: drawn here, in the tree layout the
port declares (``repro_torch.models.transformer.abstract_params``, checked
against it), and handed to the program and to the reference alike.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def port_config(cfg: Dict[str, Any]):
    """The port's ``LatentMoEConfig`` for a configuration file's keys
    (HF's ``config.json`` names)."""
    from repro_torch.configs import LatentMoEConfig

    rs = cfg["rope_scaling"]
    if cfg["scoring_func"] != "softmax" or cfg["topk_method"] != "greedy" \
            or rs["type"] != "yarn" or cfg["moe_layer_freq"] != 1:
        raise ValueError("the port runs softmax scoring, greedy top-k, "
                         "YaRN and an MoE layer after every dense one")
    return LatentMoEConfig(
        name=cfg["name"], family="mla_moe",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        head_dim=cfg["qk_nope_head_dim"],
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]),
        n_experts=cfg["n_routed_experts"], top_k=cfg["num_experts_per_tok"],
        d_ff_expert=cfg["moe_intermediate_size"],
        q_lora_rank=cfg["q_lora_rank"] or 0,
        kv_lora_rank=cfg["kv_lora_rank"],
        rope_head_dim=cfg["qk_rope_head_dim"],
        nope_head_dim=cfg["qk_nope_head_dim"],
        v_head_dim=cfg["v_head_dim"],
        n_shared_experts=cfg["n_shared_experts"],
        first_dense=cfg["first_k_dense_replace"],
        router_score=cfg["scoring_func"],
        norm_topk=bool(cfg["norm_topk_prob"]),
        routed_scale=float(cfg["routed_scaling_factor"]),
        yarn_factor=float(rs["factor"]),
        yarn_original_len=int(rs["original_max_position_embeddings"]),
        yarn_beta_fast=float(rs["beta_fast"]),
        yarn_beta_slow=float(rs["beta_slow"]),
        yarn_mscale=float(rs["mscale"]),
        yarn_mscale_all_dim=float(rs["mscale_all_dim"]))


def leaf_shapes(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The weight tree's shapes: ``dense_layers`` (the first
    ``first_k_dense_replace`` layers) beside ``layers`` (the MoE ones)."""
    nd = cfg["first_k_dense_replace"]
    nm = cfg["num_hidden_layers"] - nd
    d, h, v = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["vocab_size"]
    rkv, dr = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    dn, dv = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
    e, fe = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs, f = cfg["n_shared_experts"] * fe, cfg["intermediate_size"]

    def attn(n):
        return {"wq": (n, d, h, dn + dr), "wkv_a": (n, d, rkv + dr),
                "wk_b": (n, rkv, h, dn), "wv_b": (n, rkv, h, dv),
                "wo": (n, h, dv, d), "kv_norm": (n, rkv)}
    return {"embed": (v, d), "final_norm": (d,), "lm_head": (d, v),
            "dense_layers": {"ln1": (nd, d), "ln2": (nd, d), "attn": attn(nd),
                             "mlp": {"gate": (nd, d, f), "up": (nd, d, f),
                                     "down": (nd, f, d)}},
            "layers": {"ln1": (nm, d), "ln2": (nm, d), "attn": attn(nm),
                       "moe": {"router": (nm, d, e),
                               "w_gate": (nm, e, d, fe),
                               "w_up": (nm, e, d, fe),
                               "w_down": (nm, e, fe, d),
                               "shared_gate": (nm, d, fs),
                               "shared_up": (nm, d, fs),
                               "shared_down": (nm, fs, d)}}}


NORMS = ("final_norm", "ln1", "ln2", "kv_norm")


def _stds(cfg: Dict[str, Any]) -> Dict[str, float]:
    """Each matrix's standard deviation, 1/sqrt(its fan-in within one
    layer); the embedding's and the output head's from the
    configuration's ``init``."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    rkv, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    fe = cfg["moe_intermediate_size"]
    return {"embed": float(cfg["init"]["embed_std"]),
            "lm_head": float(cfg["init"]["head_std"]),
            "wq": d ** -0.5, "wkv_a": d ** -0.5, "wk_b": rkv ** -0.5,
            "wv_b": rkv ** -0.5, "wo": (h * dv) ** -0.5,
            "gate": d ** -0.5, "up": d ** -0.5,
            "down": cfg["intermediate_size"] ** -0.5,
            "router": d ** -0.5, "w_gate": d ** -0.5, "w_up": d ** -0.5,
            "w_down": fe ** -0.5, "shared_gate": d ** -0.5,
            "shared_up": d ** -0.5,
            "shared_down": (cfg["n_shared_experts"] * fe) ** -0.5}


def draw_weights(cfg: Dict[str, Any], seed: int, device,
                 dtype=torch.bfloat16) -> Dict[str, Any]:
    """The weights from ``seed``: one normal draw per leaf by a generator
    on ``device``, in ``dtype`` (the router in float32); norm scales are
    ones."""
    gen = torch.Generator(device).manual_seed(int(seed) % (1 << 63))
    stds = _stds(cfg)

    def draw(name, shape):
        dt = torch.float32 if name == "router" else dtype
        if name in NORMS:
            return torch.ones(shape, dtype=dt, device=device)
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
