"""~100M-parameter dense LM used by the end-to-end example driver
(examples/train_e2e.py): real training on CPU for a few hundred steps with
the AutoComp-managed data pipeline.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="paper-lm-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=2048,
    vocab=32000,
    head_dim=64,
    tie_embeddings=True,
    rope_theta=1e4,
)
