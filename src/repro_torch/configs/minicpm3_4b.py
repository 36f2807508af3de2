"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B; dense with MLA attention].

62L d_model=2560 40H d_ff=6400 vocab=73448 — Multi-head Latent Attention:
q_lora_rank=768, kv_lora_rank=256, qk_rope_head_dim=32, qk_nope_head_dim=64,
v_head_dim=64. (Config sheet lists kv=40; under MLA the KV cache is the
shared latent, so n_kv_heads is recorded but the cache stores the latent.)
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="mla",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    head_dim=64,
    q_lora_rank=768,
    kv_lora_rank=256,
    rope_head_dim=32,
    nope_head_dim=64,
    v_head_dim=64,
    rope_theta=1e6,
)
