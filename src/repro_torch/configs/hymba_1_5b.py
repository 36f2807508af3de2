"""Hymba-1.5B [arXiv:2411.13676; hybrid parallel attn+mamba heads].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Attention heads use sliding-window attention (global KV bounded), running in
parallel with mamba (SSM) heads inside each layer — this is what makes
long_500k decode feasible (sub-quadratic, bounded cache).
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    attn_window=2048,
    rope_theta=1e4,
)
