"""DeepSeek-V2-Lite [hf:deepseek-ai/DeepSeek-V2-Lite; mla_moe].

27L d_model=2048 16H vocab=102400, untied. MLA with no q-LoRA:
kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
v_head_dim=128; YaRN rope scaling (factor 40 over 4096 positions,
beta_fast 32, beta_slow 1, mscale = mscale_all_dim = 0.707), rope_theta
1e4. Layer 0 is a dense SwiGLU of width 10944; layers 1-26 are MoE: 64
routed experts of width 1408, top-6 greedy over softmax scores, not
renormalised (routed_scaling_factor 1), and 2 shared experts. 15.71 B
parameters.
"""
from repro_torch.configs import LatentMoEConfig

CONFIG = LatentMoEConfig(
    name="deepseek-v2-lite",
    family="mla_moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,
    vocab=102400,
    head_dim=128,
    rope_theta=10000.0,
    norm_eps=1e-6,
    n_experts=64,
    top_k=6,
    d_ff_expert=1408,
    q_lora_rank=0,
    kv_lora_rank=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    n_shared_experts=2,
    first_dense=1,
    router_score="softmax",
    norm_topk=False,
    routed_scale=1.0,
    yarn_factor=40.0,
    yarn_original_len=4096,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_mscale=0.707,
    yarn_mscale_all_dim=0.707,
)
