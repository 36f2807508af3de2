"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family; moe].

94L d_model=4096 64H (GQA kv=4) per-expert d_ff=1536 vocab=151936,
MoE 128 experts top-8.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=0,
    d_ff_expert=1536,
    n_experts=128,
    top_k=8,
    vocab=151936,
    head_dim=64,
    rope_theta=1e6,
)
