"""Granite-4.0-H-Small in the port (family ``hybrid_moe``, the port's
own): its published config, its smoke config, its place outside the JAX
package's registry, its capability record, its two-stack cache, and the
shared paths it passes through, which keep the other families' bits.

The model itself is held against its plain reference in
``bench/test_portbench_granite4h.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import attention, registry, transformer
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.train import step as step_lib


def test_published_widths_and_param_count():
    c = configs.get_config("granite-4.0-h-small")
    assert (c.family, c.n_layers, c.d_model, c.n_heads, c.n_kv_heads,
            c.head_dim, c.vocab) == ("hybrid_moe", 40, 4096, 32, 8, 128,
                                     100352)
    assert c.attn_layers == (5, 15, 25, 35) and c.n_mamba_layers == 36
    assert (c.mamba_heads, c.mamba_head_dim, c.ssm_state, c.mamba_groups,
            c.ssm_conv, c.mamba_chunk, c.ssm_expand) \
        == (128, 64, 128, 1, 4, 256, 2)
    assert (c.n_experts, c.top_k, c.d_ff_expert, c.d_ff_shared,
            c.n_shared_experts) == (72, 10, 768, 1536, 1)
    assert (c.embedding_multiplier, c.attention_multiplier,
            c.residual_multiplier, c.logits_scaling, c.nope) \
        == (12.0, 0.0078125, 0.22, 16.0, True)
    assert (c.tie_embeddings, c.norm_eps, c.norm_topk) == (True, 1e-5, True)
    assert c.softmax_scale == 1 / 128
    assert abs(c.param_count() - 32.21e9) <= 0.01e9
    assert abs(c.active_param_count() - 8.80e9) <= 0.01e9


@pytest.mark.parametrize("fn", ["get_config", "smoke_config"])
def test_param_count_is_every_leaf(fn):
    c = getattr(configs, fn)("granite-4.0-h-small")
    specs = transformer.abstract_params(c)
    n = sum(int(np.prod(s.shape)) for s in tree_leaves(
        specs, transformer.is_tensor_spec))
    assert n == c.param_count()
    # the experts not chosen, in every layer
    idle = c.n_layers * (c.n_experts - c.top_k) * 3 * c.d_model \
        * c.d_ff_expert
    assert c.active_param_count() == n - idle


def test_outside_the_reference_registry():
    assert "granite-4.0-h-small" not in configs.ARCH_IDS
    assert "granite-4.0-h-small" not in configs._REGISTRY
    assert "hybrid_moe" not in configs.FAMILIES
    with pytest.raises(ValueError, match="unknown family"):
        configs.ModelConfig("x", "hybrid_moe", 1, 8, 1, 1, 8, 8)
    c = configs.get_config("granite-4.0-h-small")
    with pytest.raises(ValueError, match="mamba_heads x mamba_head_dim"):
        dataclasses.replace(c, mamba_head_dim=32)
    with pytest.raises(ValueError, match="attn_layers"):
        dataclasses.replace(c, attn_layers=(5, 40))


def test_smoke_config_keeps_every_mechanism():
    c = configs.smoke_config("granite-4.0-h-small")
    assert c.family == "hybrid_moe" and c.nope
    assert c.n_mamba_layers >= 3 and len(c.attn_layers) >= 1
    assert c.n_experts >= 4 and c.top_k >= 2 and c.n_shared_experts == 1
    assert c.mamba_groups == 1 and c.mamba_chunk == 8
    assert all(m != 1 for m in (c.embedding_multiplier,
                                c.attention_multiplier,
                                c.residual_multiplier, c.logits_scaling))
    params = transformer.param_specs(c)
    assert "ssm" in params["layers"] and "attn" in params["attn_layers"]
    assert all("shared_gate" in params[k]["moe"]
               for k in ("layers", "attn_layers"))


def test_capabilities_are_recurrent_and_serve_only():
    caps = registry.capabilities("hybrid_moe")
    assert caps.row_state and caps.slot_stream and not caps.paged
    assert not caps.quantized_storage and not caps.ragged and not caps.trains
    c = configs.smoke_config("granite-4.0-h-small")
    with pytest.raises(NotImplementedError, match="training is unsupported "
                       "for granite-4.0-h-small-smoke.*load-balance"):
        step_lib.make_loss_fn(c)
    with pytest.raises(NotImplementedError, match="quantized_storage"):
        registry.state_store(c, 2, 8, kv_storage="int8")


def test_cache_is_two_stacks():
    """k/v over the 4 attention layers, the conv and SSM rows over the 36
    Mamba-2 layers: a slot holds 75.5 MB of Mamba-2 state, 1.8 MB of
    conv state and 16 KB a token of KV cache in bf16."""
    c = configs.get_config("granite-4.0-h-small")
    struct = transformer.cache_struct(c, 16, 2177)
    assert struct == {"k": (4, 16, 2177, 8, 128), "v": (4, 16, 2177, 8, 128),
                      "ssm_conv": (36, 16, 3, 8448),
                      "ssm_state": (36, 16, 128, 64, 128)}
    assert 36 * 128 * 64 * 128 * 2 == 75_497_472
    assert 36 * 3 * 8448 * 2 == 1_824_768
    assert 2 * 4 * 8 * 128 * 2 == 16_384
    axes = transformer.cache_axes(c, 16, 2177)
    assert "kv_seq" in axes["k"] and "kv_seq" not in axes["ssm_state"]
    store = registry.state_store(c, 16, 2177)
    assert sum(s.nbytes for s in tree_leaves(
        store.abstract_state(), transformer.is_tensor_spec)) \
        == 16 * (75_497_472 + 1_824_768 + 2177 * 16_384)


def test_each_layer_reads_its_own_place_in_its_kind():
    c = configs.smoke_config("granite-4.0-h-small")
    params = {"layers": "mamba", "attn_layers": "attn"}
    sites = transformer._layer_sites(c, params)
    assert [(p, j, keys[0]) for p, j, keys in sites] == [
        ("mamba", 0, "ssm_conv"), ("mamba", 1, "ssm_conv"),
        ("attn", 0, "k"), ("mamba", 2, "ssm_conv"),
        ("mamba", 3, "ssm_conv"), ("attn", 1, "k")]


# ---------------------------------------------------------------------------
# the shared paths keep the other families' bits
# ---------------------------------------------------------------------------

def _old_run_stack(cfg, params, x, mode, cache, pos, cache_len_total):
    """``transformer._run_stack``'s serve modes as they were before the
    ``hybrid_moe`` family: layer i reads ``cache[leaf][i]``, an
    ``mla_moe`` stack's leading dense layers from ``dense_layers``, and
    the new caches are stacked leaf by leaf."""
    first = cfg.first_dense if cfg.family == "mla_moe" else 0
    stacks = [(params["layers"], first)] * (cfg.n_layers - first)
    if first:
        stacks = [(params["dense_layers"], 0)] * first + stacks
    caches = []
    for i in range(cfg.n_layers):
        layers, off = stacks[i]
        lp = tree_map(lambda t: t[i - off], layers)
        lcache = {k: v[i] for k, v in cache.items()} \
            if cache is not None and mode == "decode" else None
        x, lc, _ = transformer._layer_body(cfg, mode, cache_len_total, x,
                                           lp, lcache, pos)
        caches.append(lc)
    new = None
    if caches[0] is not None:
        new = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
    return x, new


@pytest.mark.parametrize("arch", ["granite-3-8b", "deepseek-v2-lite"])
def test_shared_paths_keep_the_bits(arch):
    """Granite-3-8B and DeepSeek-V2-Lite (smoke, bf16): the stack's
    prefill and decode outputs and caches equal the code before this
    family's, bit for bit; their attention has no softmax scale of its
    own and applies rope."""
    c = configs.smoke_config(arch)
    assert attention._softmax_scale(c) is None or arch == "deepseek-v2-lite"
    assert not getattr(c, "nope", False)
    params = transformer.init_params(c, seed=3, device="cpu")
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 13, c.d_model, generator=g).to(torch.bfloat16)
    got = transformer._run_stack(c, params, x, "prefill")
    want = _old_run_stack(c, params, x, "prefill", None, 0, 0)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])
    cache = serve.grow_cache(got[1], transformer.abstract_cache(c, 2, 16))
    pos = torch.tensor([13, 13])
    got = transformer._run_stack(c, params, x[:, :1], "decode", cache, pos,
                                 16)
    want = _old_run_stack(c, params, x[:, :1], "decode", cache, pos, 16)
    assert torch.equal(got[0], want[0])
    assert list(got[1]) == list(want[1])
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])


def test_granite_multipliers_and_nope_are_the_config_s():
    """The embedding times 12 and the logits over 16, and attention
    without rope at the softmax scale 1/128, only for this family:
    forcing the multipliers to 1 and a plain scale changes the logits."""
    c = configs.smoke_config("granite-4.0-h-small")
    params = transformer.init_params(c, seed=1, device="cpu")
    tok = torch.randint(0, c.vocab, (1, 9),
                        generator=torch.Generator().manual_seed(2))
    base = transformer.forward(c, params, {"tokens": tok}, "encode")[0]
    for change in ({"embedding_multiplier": 1.0}, {"logits_scaling": 1.0},
                   {"residual_multiplier": 1.0},
                   {"attention_multiplier": 0.25}, {"nope": False}):
        other = dataclasses.replace(c, **change)
        out = transformer.forward(other, params, {"tokens": tok},
                                  "encode")[0]
        assert not torch.equal(out, base), change
