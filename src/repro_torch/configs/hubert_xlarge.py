"""HuBERT-XLarge [arXiv:2106.07447; audio encoder-only].

48L d_model=1280 16H d_ff=5120 vocab=504 (masked-unit prediction targets).
Encoder-only (bidirectional, no decode shapes). The conv waveform frontend is
a STUB: input_specs() supplies precomputed frame embeddings (B, S, d_model).
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder_audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    head_dim=80,
    causal=False,
    frontend="audio_frames",
)
