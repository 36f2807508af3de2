"""The port's configs, parameter init and weight carry-over.

``repro_torch.configs`` is a copy of ``repro.configs``: every arch's
config, smoke config and parameter count equal the reference's.
``init_params`` builds the specs' shapes and dtypes on the device asked
for (the card by default). ``params_from_jax`` carries the reference's
tree across bit for bit, bf16 leaves included, without ``ml_dtypes``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.models import TransformerLM, init_params, params_from_jax
from repro_torch.models import transformer as tf
from repro_torch.models.common import Spec, tree_leaves, tree_map
from repro_torch.models.interop import tree_from_numpy

ALL_ARCHS = tuple(ref_configs._REGISTRY)


def test_registry_and_families_match_the_reference():
    assert configs.FAMILIES == ref_configs.FAMILIES
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert sorted(configs._REGISTRY) == sorted(ref_configs._REGISTRY)
    assert all(v.startswith("repro_torch.configs.")
               for v in configs._REGISTRY.values())


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_smoke_config_and_param_count_match(arch):
    for fn in ("get_config", "smoke_config"):
        got = getattr(configs, fn)(arch)
        want = getattr(ref_configs, fn)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert (got.q_dim, got.kv_dim, got.sub_quadratic, got.supports_decode) \
            == (want.q_dim, want.kv_dim, want.sub_quadratic, want.supports_decode)


def test_unknown_arch_and_family_raise():
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("nope")
    with pytest.raises(ValueError, match="unknown family"):
        configs.ModelConfig("x", "rnn", 1, 8, 1, 1, 8, 8)


def _spec_dtype(spec):
    return spec.dtype or torch.bfloat16


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_specs_match_the_reference_specs(arch):
    """The same tree, leaf shapes, dtypes, logical axes and inits."""
    cfg = configs.smoke_config(arch)
    mine = tf.param_specs(cfg)
    ref = ref_tf.param_specs(ref_configs.smoke_config(arch))
    is_spec = lambda x: isinstance(x, Spec)  # noqa: E731
    pairs = []
    tree_map(lambda a, b: pairs.append((a, b)), mine,
             jax.tree.map(lambda s: s, ref, is_leaf=lambda x: hasattr(x, "axes")),
             is_leaf=is_spec)
    assert pairs
    for a, b in pairs:
        assert (a.shape, a.axes, a.init) == (b.shape, b.axes, b.init)
        want = jnp.dtype(b.dtype or jnp.bfloat16).name
        assert str(_spec_dtype(a)).replace("torch.", "") == want


def test_init_params_shapes_dtypes_and_exact_inits():
    cfg = configs.smoke_config("hymba-1.5b")
    specs = tf.param_specs(cfg)
    params = init_params(cfg, seed=5, device="cpu")
    pairs = []
    tree_map(lambda s, t: pairs.append((s, t)), specs, params,
             is_leaf=lambda x: isinstance(x, Spec))
    for spec, t in pairs:
        assert tuple(t.shape) == spec.shape and t.dtype == _spec_dtype(spec)
        assert t.device.type == "cpu"
        if spec.init == "zeros":
            assert torch.equal(t, torch.zeros_like(t))
        elif spec.init == "ones":
            assert torch.equal(t, torch.ones_like(t))
        else:
            assert t.float().std() > 0
    # fan-in scaled as the reference scales: every axis but the last,
    # the stacked layers axis included
    wq = params["layers"]["attn"]["wq"]
    fan_in = int(np.prod(wq.shape[:-1]))
    assert abs(float(wq.float().std()) * np.sqrt(fan_in) - 1.0) < 0.1
    assert params["layers"]["ssm"]["a_log"].dtype == torch.float32
    again = init_params(cfg, seed=5, device="cpu")
    other = init_params(cfg, seed=6, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(params), tree_leaves(again)))
    assert not torch.equal(params["embed"], other["embed"])


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.smoke_config("granite-3-8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(cfg)
    tree = jax.tree.map(np.asarray,
                        ref_tf.init_params(ref_configs.smoke_config("granite-3-8b"),
                                           jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(cfg, tree)
    assert TransformerLM(cfg, device="cpu").embed.device.type == "cpu"


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "xlstm-125m",
                                  "internvl2-2b"])
def test_params_from_jax_is_bit_exact(arch):
    ref_tree = ref_tf.init_params(ref_configs.smoke_config(arch),
                                  jax.random.PRNGKey(1))
    np_tree = jax.tree.map(np.asarray, ref_tree)
    got = params_from_jax(configs.smoke_config(arch), np_tree, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, np_tree))
    n_bf16 = 0
    for t, a in zip(tree_leaves(got), jax.tree.leaves(np_tree)):
        assert str(t.dtype).replace("torch.", "") == a.dtype.name
        assert tuple(t.shape) == a.shape
        if a.dtype.name == "bfloat16":
            n_bf16 += 1
            assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  a.view(np.uint16))
        else:
            assert np.array_equal(t.numpy(), a)
    assert n_bf16 > 0
    if arch.startswith("qwen3-moe"):           # the router stays f32
        assert got["layers"]["moe"]["router"].dtype == torch.float32


def test_tree_from_numpy_keeps_f32_int_and_bool_bits():
    rng = np.random.default_rng(0)
    f = rng.standard_normal((3, 4)).astype(np.float32)
    f[0, 0] = -0.0
    tree = {"f": f, "blocks": [{"i": np.arange(-3, 5, dtype=np.int32)},
                               {"b": np.array([True, False])}],
            "h": np.asarray(jnp.asarray(f, jnp.bfloat16))}
    got = tree_from_numpy(tree, torch.device("cpu"))
    assert np.array_equal(got["f"].numpy().view(np.uint32), f.view(np.uint32))
    assert got["blocks"][0]["i"].dtype == torch.int32
    assert np.array_equal(got["blocks"][0]["i"].numpy(), tree["blocks"][0]["i"])
    assert got["blocks"][1]["b"].dtype == torch.bool
    assert got["h"].dtype == torch.bfloat16
    assert np.array_equal(got["h"].view(torch.int16).numpy().view(np.uint16),
                          tree["h"].view(np.uint16))


def test_params_from_jax_rejects_another_layout():
    cfg = configs.smoke_config("granite-3-8b")
    tree = jax.tree.map(np.asarray, ref_tf.init_params(
        ref_configs.smoke_config("granite-3-8b"), jax.random.PRNGKey(0)))
    bad = dict(tree, embed=tree["embed"][:, :8])
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(cfg, bad, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="structure"):
        params_from_jax(cfg, missing, device="cpu")
