"""Granite-4.0-H-Small [hf:ibm-granite/granite-4.0-h-small; hybrid_moe].

40L d_model=4096 vocab=100352, tied, RMSNorm eps 1e-5. 36 Mamba-2 layers
and 4 attention layers (indices 5, 15, 25, 35). Mamba-2: 128 heads of 64
(inner width 8192 = 2 x 4096), state 128, one group, conv 4 with bias,
chunk 256, no projection bias. Attention: GQA 32 heads, 8 KV heads,
head_dim 128, NoPE. Every layer's mixer is followed by an MoE of 72
routed experts of width 768, top-10, and a shared SwiGLU of width 1536.
Multipliers: embedding 12, attention 0.0078125, residual 0.22, logits
1/16. 32.21 B parameters, 8.80 B active.
"""
from repro_torch.configs import HybridMoEConfig

CONFIG = HybridMoEConfig(
    name="granite-4.0-h-small",
    family="hybrid_moe",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=0,
    vocab=100352,
    head_dim=128,
    tie_embeddings=True,
    rope_theta=10000.0,
    norm_eps=1e-5,
    n_experts=72,
    top_k=10,
    d_ff_expert=768,
    d_ff_shared=1536,
    attn_layers=(5, 15, 25, 35),
    ssm_state=128,
    ssm_expand=2,
    ssm_conv=4,
    mamba_heads=128,
    mamba_head_dim=64,
    mamba_groups=1,
    mamba_chunk=256,
    embedding_multiplier=12.0,
    attention_multiplier=0.0078125,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    nope=True,
)
