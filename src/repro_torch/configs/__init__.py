"""Architecture config registry.

Each assigned architecture lives in its own module exporting ``CONFIG``.
``get_config(arch_id)`` returns the full published config; ``smoke_config``
shrinks any config to a CPU-runnable size for smoke tests (same family, same
code paths, tiny dims).
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import ClassVar, Optional, Tuple

FAMILIES = ("dense", "moe", "mla", "hybrid", "ssm_xlstm", "encoder_audio", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    families: ClassVar[Tuple[str, ...]] = FAMILIES

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
        if self.family not in self.families:
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


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention scale for a context stretched ``factor`` times
    (DeepSeek-V2's ``yarn_get_mscale``)."""
    if factor <= 1:
        return 1.0
    return 0.1 * mscale * math.log(factor) + 1.0


@dataclasses.dataclass(frozen=True)
class LatentMoEConfig(ModelConfig):
    """DeepSeek-V2's block (family ``"mla_moe"``): latent attention (the
    MLA fields above; ``q_lora_rank=0`` projects the query directly, with
    no query norm), ``first_dense`` leading layers with a dense SwiGLU of
    width ``d_ff``, then MoE layers of ``n_experts`` routed experts of
    width ``d_ff_expert`` and ``n_shared_experts`` shared ones, run as one
    SwiGLU of width ``n_shared_experts * d_ff_expert`` on every token.

    The router scores by ``router_score`` ("softmax", in f32) and takes
    the ``top_k`` best (greedy); their scores are the gates, divided by
    their sum if ``norm_topk`` and otherwise multiplied by
    ``routed_scale``. No token is dropped.

    ``yarn_factor > 1`` turns on YaRN rope scaling: frequencies
    interpolated ``yarn_factor`` times below a ramp between the dims that
    turn ``yarn_beta_fast`` and ``yarn_beta_slow`` times over
    ``yarn_original_len`` positions, and the softmax scale multiplied by
    ``yarn_mscale(yarn_factor, yarn_mscale_all_dim) ** 2``. YaRN's
    multiplier of cos and sin, ``yarn_mscale(yarn_factor, yarn_mscale) /
    yarn_mscale(yarn_factor, yarn_mscale_all_dim)``, must be 1 (equal
    ``yarn_mscale`` and ``yarn_mscale_all_dim``, as DeepSeek-V2 sets them).

    A family of the port alone: the JAX package has no counterpart, so it
    is not in ``FAMILIES``.
    """
    families: ClassVar[Tuple[str, ...]] = ("mla_moe",)

    n_shared_experts: int = 0
    first_dense: int = 0
    router_score: str = "softmax"
    norm_topk: bool = False
    routed_scale: float = 1.0
    yarn_factor: float = 1.0
    yarn_original_len: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    def __post_init__(self):
        super().__post_init__()
        if self.router_score != "softmax":
            raise ValueError(f"unknown router_score {self.router_score!r}")
        if not 0 <= self.first_dense < self.n_layers:
            raise ValueError(f"first_dense {self.first_dense} must leave "
                             f"MoE layers among {self.n_layers}")
        if yarn_mscale(self.yarn_factor, self.yarn_mscale) \
                != yarn_mscale(self.yarn_factor, self.yarn_mscale_all_dim):
            raise ValueError("YaRN's cos/sin multiplier must be 1: "
                             "yarn_mscale == yarn_mscale_all_dim")

    @property
    def d_ff_shared(self) -> int:
        return self.n_shared_experts * self.d_ff_expert

    @property
    def softmax_scale(self) -> float:
        """The attention's softmax scale: 1/sqrt(query head dim), times
        YaRN's ``mscale_all_dim`` factor squared."""
        m = yarn_mscale(self.yarn_factor, self.yarn_mscale_all_dim) \
            if self.yarn_mscale_all_dim else 1.0
        return (self.nope_head_dim + self.rope_head_dim) ** -0.5 * m * m


@dataclasses.dataclass(frozen=True)
class HybridMoEConfig(ModelConfig):
    """Granite-4.0-H's block (family ``"hybrid_moe"``): a stack of Mamba-2
    mixers with GQA attention mixers at the layer indices
    ``attn_layers``, every mixer followed by a dropless MoE of
    ``n_experts`` routed experts of width ``d_ff_expert`` (top ``top_k``)
    and one shared SwiGLU of width ``d_ff_shared``.

    The Mamba-2 mixer has ``mamba_heads`` heads of ``mamba_head_dim``
    (their product is ``ssm_expand * d_model``), a state of ``ssm_state``
    per head and channel, B and C shared over ``mamba_groups`` groups of
    heads, a causal conv of width ``ssm_conv`` (with bias) over x, B and C,
    and a prefill chunk of ``mamba_chunk`` positions.

    Granite's multipliers: the embedding times ``embedding_multiplier``,
    the attention's softmax scale ``attention_multiplier``, each mixer's
    and each MoE's output times ``residual_multiplier`` before its
    residual add, and the logits divided by ``logits_scaling``. ``nope``:
    the attention applies no rotary positions. The router softmaxes the
    ``top_k`` best logits, which is a softmax over every expert
    renormalised over the chosen ones.

    A family of the port alone, outside ``FAMILIES`` as ``mla_moe`` is.
    """
    families: ClassVar[Tuple[str, ...]] = ("hybrid_moe",)
    # the dropless MoE's router (models/moe.py::route): renormalised gates
    norm_topk: ClassVar[bool] = True
    routed_scale: ClassVar[float] = 1.0

    attn_layers: Tuple[int, ...] = ()
    mamba_heads: int = 0
    mamba_head_dim: int = 0
    mamba_groups: int = 1
    mamba_chunk: int = 256
    d_ff_shared: int = 0
    embedding_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    nope: bool = False

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "attn_layers", tuple(self.attn_layers))
        if any(not 0 <= i < self.n_layers for i in self.attn_layers) \
                or len(set(self.attn_layers)) != len(self.attn_layers):
            raise ValueError(f"attn_layers {self.attn_layers} must be "
                             f"distinct layer indices below {self.n_layers}")
        if self.mamba_heads * self.mamba_head_dim \
                != self.ssm_expand * self.d_model:
            raise ValueError("mamba_heads x mamba_head_dim must equal "
                             "ssm_expand x d_model")
        if self.mamba_heads % self.mamba_groups:
            raise ValueError("mamba_groups must divide mamba_heads")

    @property
    def n_shared_experts(self) -> int:
        return 1 if self.d_ff_shared else 0

    @property
    def n_mamba_layers(self) -> int:
        return self.n_layers - len(self.attn_layers)

    @property
    def softmax_scale(self) -> float:
        return self.attention_multiplier or self.head_dim ** -0.5


def _hybrid_moe_count(c: HybridMoEConfig, active_only: bool) -> int:
    """Every leaf of the ``hybrid_moe`` tree, norm scales included."""
    d = c.d_model
    di = c.ssm_expand * d
    conv = di + 2 * c.mamba_groups * c.ssm_state
    mamba = d * (di + conv + c.mamba_heads) + c.ssm_conv * conv + conv \
        + 3 * c.mamba_heads + di + di * d
    attn = 2 * d * c.q_dim + 2 * d * c.kv_dim
    routed = c.top_k if active_only else c.n_experts
    moe = d * c.n_experts + 3 * d * (routed * c.d_ff_expert + c.d_ff_shared)
    emb = c.vocab * d * (1 if c.tie_embeddings else 2) + d
    return emb + c.n_mamba_layers * mamba + len(c.attn_layers) * attn \
        + c.n_layers * (moe + 2 * d)


def _latent_moe_count(c: LatentMoEConfig, active_only: bool) -> int:
    """Every leaf of the ``mla_moe`` tree, norm scales included."""
    d, h = c.d_model, c.n_heads
    qk = c.nope_head_dim + c.rope_head_dim
    attn = (d * c.q_lora_rank + c.q_lora_rank + c.q_lora_rank * h * qk
            if c.q_lora_rank else d * h * qk)
    attn += d * (c.kv_lora_rank + c.rope_head_dim) + c.kv_lora_rank
    attn += c.kv_lora_rank * h * (c.nope_head_dim + c.v_head_dim)
    attn += h * c.v_head_dim * d
    routed = c.top_k if active_only else c.n_experts
    moe = d * c.n_experts + 3 * d * (routed * c.d_ff_expert + c.d_ff_shared)
    emb = c.vocab * d * (1 if c.tie_embeddings else 2) + d
    return emb + c.n_layers * (attn + 2 * d) + c.first_dense * 3 * d * c.d_ff \
        + (c.n_layers - c.first_dense) * moe


def _param_count(c: ModelConfig, active_only: bool) -> int:
    if c.family == "mla_moe":
        return _latent_moe_count(c, active_only)
    if c.family == "hybrid_moe":
        return _hybrid_moe_count(c, active_only)
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

# configurations of the port's own families, outside ARCH_IDS (the JAX
# package has no counterpart)
_PORT_REGISTRY = {
    "deepseek-v2-lite": "repro_torch.configs.deepseek_v2_lite",
    "granite-4.0-h-small": "repro_torch.configs.granite_4_0_h_small",
}


def get_config(arch_id: str) -> ModelConfig:
    mod = _REGISTRY.get(arch_id) or _PORT_REGISTRY.get(arch_id)
    if mod is None:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_REGISTRY) + sorted(_PORT_REGISTRY)}")
    return importlib.import_module(mod).CONFIG


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
    if c.family == "mla_moe":
        # every mechanism kept: the leading dense layers, two MoE layers
        # or more, shared experts, the router's settings, YaRN (whose
        # ramp still falls inside 8 rope dims) and a direct query
        base = {f.name for f in dataclasses.fields(ModelConfig)}
        kw.update({f.name: getattr(c, f.name)
                   for f in dataclasses.fields(c) if f.name not in base})
        kw.update(n_layers=max(n_layers, c.first_dense + 2),
                  q_lora_rank=min(c.q_lora_rank, 32), kv_lora_rank=16,
                  rope_head_dim=8, nope_head_dim=8, v_head_dim=16,
                  n_experts=8, top_k=3, d_ff_expert=16,
                  rope_theta=c.rope_theta, norm_eps=c.norm_eps)
        return LatentMoEConfig(**kw)
    if c.family == "hybrid_moe":
        # every mechanism kept: Mamba-2 layers around attention layers in
        # the published period's order (4 and 2 of 6), one group, the
        # shared expert, Granite's multipliers, NoPE, and a chunk of 8,
        # so that prefills cross chunk boundaries and end ragged
        base = {f.name for f in dataclasses.fields(ModelConfig)}
        kw.update({f.name: getattr(c, f.name)
                   for f in dataclasses.fields(c) if f.name not in base})
        kw.update(n_layers=6, attn_layers=(2, 5), ssm_state=16,
                  ssm_expand=c.ssm_expand, ssm_conv=c.ssm_conv,
                  mamba_heads=8, mamba_head_dim=16, mamba_chunk=8,
                  n_experts=8, top_k=3, d_ff_expert=16, d_ff_shared=32,
                  rope_theta=c.rope_theta, norm_eps=c.norm_eps)
        return HybridMoEConfig(**kw)
    return ModelConfig(**kw)
