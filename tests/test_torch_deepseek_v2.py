"""DeepSeek-V2-Lite in the port (family ``mla_moe``, the port's own): its
published config, its smoke config, its place outside the JAX package's
registry, its capability record, and the attention scale it adds, whose
default keeps the other families' bits.

The model itself is held against its plain reference in
``bench/test_portbench_deepseek.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import common, registry, transformer
from repro_torch.models.common import tree_leaves
from repro_torch.train import step as step_lib


def test_published_widths_and_param_count():
    c = configs.get_config("deepseek-v2-lite")
    assert (c.family, c.n_layers, c.d_model, c.n_heads, c.vocab) \
        == ("mla_moe", 27, 2048, 16, 102400)
    assert (c.q_lora_rank, c.kv_lora_rank, c.nope_head_dim,
            c.rope_head_dim, c.v_head_dim) == (0, 512, 128, 64, 128)
    assert (c.first_dense, c.d_ff, c.n_experts, c.top_k, c.d_ff_expert,
            c.n_shared_experts, c.d_ff_shared) \
        == (1, 10944, 64, 6, 1408, 2, 2816)
    assert (c.norm_topk, c.routed_scale, c.tie_embeddings) \
        == (False, 1.0, False)
    assert (c.yarn_factor, c.yarn_original_len, c.yarn_mscale,
            c.yarn_mscale_all_dim) == (40.0, 4096, 0.707, 0.707)
    assert abs(c.param_count() - 15.71e9) <= 0.01e9


@pytest.mark.parametrize("fn", ["get_config", "smoke_config"])
def test_param_count_is_every_leaf(fn):
    c = getattr(configs, fn)("deepseek-v2-lite")
    specs = transformer.abstract_params(c)
    n = sum(int(np.prod(s.shape)) for s in tree_leaves(
        specs, transformer.is_tensor_spec))
    assert n == c.param_count()
    # the experts not chosen, in every MoE layer
    idle = (c.n_layers - c.first_dense) * (c.n_experts - c.top_k) \
        * 3 * c.d_model * c.d_ff_expert
    assert c.active_param_count() == n - idle


def test_outside_the_reference_registry():
    assert "deepseek-v2-lite" not in configs.ARCH_IDS
    assert "deepseek-v2-lite" not in configs._REGISTRY
    assert "mla_moe" not in configs.FAMILIES
    with pytest.raises(ValueError, match="unknown family"):
        configs.ModelConfig("x", "mla_moe", 1, 8, 1, 1, 8, 8)
    with pytest.raises(ValueError, match="cos/sin multiplier"):
        dataclasses.replace(configs.get_config("deepseek-v2-lite"),
                            yarn_mscale=1.0)


def test_smoke_config_keeps_every_mechanism():
    c = configs.smoke_config("deepseek-v2-lite")
    assert c.family == "mla_moe" and c.first_dense == 1
    assert c.n_layers - c.first_dense >= 2 and c.n_shared_experts == 2
    assert c.q_lora_rank == 0 and c.yarn_factor == 40.0
    # YaRN's ramp still falls inside the 8 rope dims: kept, ramped, divided
    f = common.yarn_freqs(c.rope_head_dim, c.rope_theta, c.yarn_factor,
                          c.yarn_original_len, c.yarn_beta_fast,
                          c.yarn_beta_slow)
    plain = common.rope_freqs(c.rope_head_dim, c.rope_theta)
    assert f[0] == plain[0] and torch.isclose(f[-1], plain[-1] / 40)
    assert plain[2] / 40 < f[2] < plain[2]
    params = transformer.param_specs(c)
    assert "wq" in params["layers"]["attn"] and "q_norm" not in \
        params["layers"]["attn"]
    assert "mlp" in params["dense_layers"] and "shared_gate" in \
        params["layers"]["moe"]


def test_serve_only_capability_refuses_training():
    caps = registry.capabilities("mla_moe")
    assert caps.slot_stream and caps.quantized_storage and not caps.trains
    assert all(registry.capabilities(f).trains for f in configs.FAMILIES)
    c = configs.smoke_config("deepseek-v2-lite")
    with pytest.raises(NotImplementedError, match="training is unsupported "
                       "for deepseek-v2-lite-smoke.*load-balance"):
        step_lib.make_loss_fn(c)


def test_cache_is_one_latent_stack():
    c = configs.get_config("deepseek-v2-lite")
    struct = transformer.cache_struct(c, 32, 2177)
    assert struct == {"latent": (27, 32, 2177, 512),
                      "k_rope": (27, 32, 2177, 1, 64)}
    # 576 values a token a layer, 31.1 KB a token in bf16
    assert sum(np.prod(s[3:]) for s in struct.values()) * 27 * 2 == 31104
    assert set(transformer.cache_struct(c, 2, 8, "int8")) == {
        "latent", "k_rope", "latent_scale", "k_rope_scale"}


def _old_decode_attention(q, k_cache, v_cache, k_positions, pos):
    """``decode_attention`` as it was before its ``scale`` argument."""
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    scale = 1.0 / np.sqrt(d)
    qg = q.reshape(b, hkv, h // hkv, d).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    pos_b = common.as_positions(pos, q.device).expand(b)
    kp = common.as_positions(k_positions, q.device)[None, :]
    valid = ((kp >= 0) & (kp <= pos_b[:, None])).expand(b, k_cache.shape[1])
    s = torch.where(valid[:, None, None, :], s, common.NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return o.reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_default_scale_keeps_the_bits(dtype):
    """Granite's path: without ``scale`` both attentions compute today's
    1/sqrt(d) bit for bit, and an explicit scale moves them."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 1, 4, 16, generator=g).to(dtype)
    k = torch.randn(2, 12, 2, 16, generator=g).to(dtype)
    v = torch.randn(2, 12, 2, 16, generator=g).to(dtype)
    kp, pos = torch.arange(12, dtype=torch.int32), torch.tensor([7, 11])
    got = common.decode_attention(q, k, v, kp, pos)
    assert torch.equal(got, _old_decode_attention(q, k, v, kp, pos))
    assert torch.equal(got, common.decode_attention(
        q, k, v, kp, pos, scale=1.0 / np.sqrt(16)))
    assert not torch.equal(got, common.decode_attention(q, k, v, kp, pos,
                                                        scale=0.5))
    qs = torch.randn(2, 12, 4, 16, generator=g).to(dtype)
    got = common.blockwise_attention(qs, k, v, block_q=8, block_k=8)
    assert torch.equal(got, common.blockwise_attention(
        qs, k, v, block_q=8, block_k=8, scale=1.0 / np.sqrt(16)))
    assert not torch.equal(got, common.blockwise_attention(
        qs, k, v, block_q=8, block_k=8, scale=0.5))
