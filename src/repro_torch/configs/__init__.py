"""Architecture config registry.

Each assigned architecture lives in its own module exporting ``CONFIG``.
``get_config(arch_id)`` returns the full published config; ``smoke_config``
shrinks any config to a CPU-runnable size for smoke tests (same family, same
code paths, tiny dims).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "mla", "hybrid", "ssm_xlstm", "encoder_audio", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                        # dense FFN hidden (0 => no separate FFN, e.g. xLSTM)
    vocab: int
    head_dim: int = 0                # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # --- MoE (family == "moe") ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001

    # --- MLA (family == "mla") ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM / hybrid (families "hybrid", "ssm_xlstm") ---
    ssm_state: int = 0
    ssm_expand: int = 2              # d_inner = ssm_expand * d_model (hymba mamba heads)
    ssm_conv: int = 4
    attn_window: int = 0             # sliding-window attention width (hybrid long ctx); 0 => full
    mlstm_every: int = 2             # xLSTM: every k-th block is mLSTM (others sLSTM)
    proj_factor_mlstm: float = 2.0   # xLSTM block expansion
    proj_factor_slstm: float = 1.3334

    # --- modality stubs ---
    frontend: str = "none"           # "none" | "audio_frames" | "vit_patches"
    n_vision_tokens: int = 0         # vlm: patch tokens prepended inside seq_len

    # --- structural flags ---
    causal: bool = True              # False => encoder-only (no decode shapes)
    remat_block: int = 1             # layers per remat unit (coarser blocks
                                     # halve saved activations per unit)

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived quantities -------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Total parameter count N (used for MODEL_FLOPS = 6*N*D)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: only top_k experts)."""
        return _param_count(self, active_only=True)

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is feasible (bounded state per token)."""
        return self.family in ("hybrid", "ssm_xlstm")

    @property
    def supports_decode(self) -> bool:
        return self.causal


def _param_count(c: ModelConfig, active_only: bool) -> int:
    d = c.d_model
    emb = c.vocab * d * (1 if c.tie_embeddings else 2)
    per_layer = 0
    if c.family == "mla":
        qk_head = c.nope_head_dim + c.rope_head_dim
        per_layer += d * c.q_lora_rank + c.q_lora_rank * c.n_heads * qk_head
        per_layer += d * (c.kv_lora_rank + c.rope_head_dim)
        per_layer += c.kv_lora_rank * c.n_heads * (c.nope_head_dim + c.v_head_dim)
        per_layer += c.n_heads * c.v_head_dim * d
    elif c.family == "ssm_xlstm":
        # mLSTM / sLSTM blocks: projections + gates (approximate but counted
        # exactly from the layer definitions in models/xlstm.py).
        d_in_m = int(c.proj_factor_mlstm * d)
        d_in_s = d  # sLSTM operates at model width
        n_m = sum(1 for i in range(c.n_layers) if i % c.mlstm_every == 0)
        n_s = c.n_layers - n_m
        m_block = 2 * d * d_in_m + 3 * d_in_m * d_in_m // c.n_heads + d_in_m * d
        ff_s = int(c.proj_factor_slstm * d)
        s_block = 4 * d_in_s * d_in_s + 4 * d_in_s * (d_in_s // c.n_heads) + 3 * d * ff_s
        return emb + n_m * m_block + n_s * s_block
    else:
        per_layer += d * c.q_dim + d * c.kv_dim * 2 + c.q_dim * d  # q, k, v, o
        if c.qkv_bias:
            per_layer += c.q_dim + 2 * c.kv_dim
    if c.family == "hybrid":
        d_inner = c.ssm_expand * d
        per_layer += d * d_inner * 2          # in_proj (x, z)
        per_layer += d_inner * (c.ssm_state * 2 + 1)  # B, C, dt projections (fused, low rank)
        per_layer += d_inner * c.ssm_conv + d_inner   # conv + A/D
        per_layer += d_inner * d              # out proj (shared with attn out add)
    if c.family == "moe":
        e = c.n_experts if not active_only else c.top_k
        per_layer += d * c.n_experts          # router
        per_layer += e * 3 * d * c.d_ff_expert
    elif c.d_ff > 0:
        per_layer += 3 * d * c.d_ff           # swiglu gate/up/down
    per_layer += 2 * d                        # norms
    return emb + c.n_layers * per_layer


_REGISTRY = {
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "qwen1.5-110b": "repro_torch.configs.qwen1_5_110b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "paper-lm-100m": "repro_torch.configs.paper_lm_100m",
}

ARCH_IDS: Tuple[str, ...] = tuple(k for k in _REGISTRY if k != "paper-lm-100m")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return importlib.import_module(_REGISTRY[arch_id]).CONFIG


def smoke_config(arch_id: str, *, n_layers: int = 2, vocab: int = 256) -> ModelConfig:
    """Shrink a config to CPU-smoke size, preserving family & code paths."""
    c = get_config(arch_id)
    kw = dict(
        name=c.name + "-smoke", family=c.family, n_layers=n_layers,
        d_model=64, n_heads=4, n_kv_heads=min(c.n_kv_heads, 2) or 2,
        d_ff=128 if c.d_ff else 0, vocab=vocab, head_dim=16,
        qkv_bias=c.qkv_bias, tie_embeddings=c.tie_embeddings, causal=c.causal,
        frontend=c.frontend,
    )
    if c.family == "moe":
        kw.update(n_experts=4, top_k=2, d_ff_expert=32, d_ff=0)
    if c.family == "mla":
        kw.update(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                  nope_head_dim=8, v_head_dim=16, head_dim=16)
    if c.family == "hybrid":
        kw.update(ssm_state=8, ssm_expand=2, ssm_conv=4, attn_window=32)
    if c.family == "ssm_xlstm":
        kw.update(mlstm_every=c.mlstm_every, d_ff=0)
    if c.family == "vlm":
        kw.update(n_vision_tokens=4)
    return ModelConfig(**kw)
