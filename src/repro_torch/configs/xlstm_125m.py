"""xLSTM-125M [arXiv:2405.04517; ssm — sLSTM + mLSTM blocks].

12L d_model=768 4H vocab=50304, d_ff=0 (blocks carry their own projections).
Every `mlstm_every`-th block is an mLSTM (matrix memory, chunkwise-parallel
training form); the rest are sLSTM (scalar memory, recurrent scan). Recurrent
state is O(1) per token => long_500k decode runs.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm_xlstm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=192,
    mlstm_every=2,
    causal=True,
)
