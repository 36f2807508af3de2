"""InternVL2-2B [arXiv:2404.16821; vlm — InternViT + InternLM2 backbone].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
This entry specifies the transformer BACKBONE (InternLM2-1.8B); the InternViT
frontend is a STUB: input_specs() provides precomputed patch embeddings that
occupy the first n_vision_tokens positions of the sequence.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    head_dim=128,
    frontend="vit_patches",
    n_vision_tokens=256,
    rope_theta=1e6,
)
