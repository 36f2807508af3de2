"""Qwen3-MoE-30B-A3B [hf:Qwen/Qwen3-30B-A3B; moe].

48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768 vocab=151936,
MoE 128 experts top-8.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=0,
    d_ff_expert=768,
    n_experts=128,
    top_k=8,
    vocab=151936,
    head_dim=64,
    rope_theta=1e6,
)
