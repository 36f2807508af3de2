"""Each module of the port's model math against the JAX package's, at a
small size, on the same numpy inputs: the output, and the gradient of every
input and parameter under the same random cotangent.

f32 bar: each output and each gradient within 3e-5 x its largest magnitude
+ 1e-6. Measured on this CPU: 9.5e-6 of the scale for the mLSTM over two
chunks, under 2e-6 for every other module, the SSM's scan in another
summation order included. bf16 forward bar: each row within
``ROW_REL_BAR`` (2e-2) of its own largest magnitude.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.models import xlstm as ref_xlstm
from repro_torch.configs import smoke_config
from repro_torch.models import attention, common, moe, ssm, xlstm

TOL, FLOOR = 3e-5, 1e-6
ROW_REL_BAR = 2e-2


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def spec_params(specs, rng, scale=0.3):
    """Random values for every leaf of a spec dict (biases and norms too,
    so a zero init hides nothing)."""
    return {k: rand(rng, *s.shape, scale=scale) for k, s in specs.items()}


def vjp_pair(ref_fn, port_fn, inputs, seed=0):
    """Both packages' outputs and gradients of ``inputs`` (a dict of f32
    numpy arrays) under one random cotangent of the output."""
    out_j, vjp = jax.vjp(ref_fn, {k: jnp.asarray(v) for k, v in inputs.items()})
    cot = np.random.default_rng(seed).standard_normal(out_j.shape) \
        .astype(np.float32)
    (g_j,) = vjp(jnp.asarray(cot))
    ts = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in inputs.items()}
    out_t = port_fn(ts)
    out_t.backward(torch.from_numpy(cot))
    g_t = {k: (torch.zeros_like(t) if t.grad is None else t.grad).numpy()
           for k, t in ts.items()}
    return (np.asarray(out_j), out_t.detach().numpy(),
            {k: np.asarray(v) for k, v in g_j.items()}, g_t)


def assert_close(got, want, what=""):
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= TOL * scale + FLOOR, (what, err, scale)


def assert_pair(ref_fn, port_fn, inputs, seed=0):
    out_j, out_t, g_j, g_t = vjp_pair(ref_fn, port_fn, inputs, seed)
    assert out_t.shape == out_j.shape
    assert_close(out_t, out_j, "output")
    for k in inputs:
        assert_close(g_t[k], g_j[k], k)
    return out_j, out_t


def row_rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.maximum(np.abs(want).max(-1), np.finfo(np.float32).tiny)
    return float((np.abs(got - want).max(-1) / scale).max())


def test_rms_norm_f32_and_bf16():
    rng = np.random.default_rng(0)
    inp = {"x": rand(rng, 3, 5, 32), "scale": rand(rng, 32)}
    assert_pair(lambda d: ref_common.rms_norm(d["x"], d["scale"], 1e-6),
                lambda d: common.rms_norm(d["x"], d["scale"], 1e-6), inp)
    want = ref_common.rms_norm(jnp.asarray(inp["x"], jnp.bfloat16),
                               jnp.asarray(inp["scale"], jnp.bfloat16))
    got = common.rms_norm(torch.from_numpy(inp["x"]).bfloat16(),
                          torch.from_numpy(inp["scale"]).bfloat16())
    assert got.dtype == torch.bfloat16
    assert row_rel(got.float(), np.asarray(want, np.float32)) <= ROW_REL_BAR


def test_apply_rope_f32_and_bf16():
    rng = np.random.default_rng(1)
    inp = {"x": rand(rng, 2, 8, 3, 16)}
    pos_j = jnp.arange(8, dtype=jnp.int32)[None] + 5
    pos_t = torch.arange(8, dtype=torch.int32)[None] + 5
    assert_pair(lambda d: ref_common.apply_rope(d["x"], pos_j, 1e4),
                lambda d: common.apply_rope(d["x"], pos_t, 1e4), inp)
    want = ref_common.apply_rope(jnp.asarray(inp["x"], jnp.bfloat16), pos_j, 1e4)
    got = common.apply_rope(torch.from_numpy(inp["x"]).bfloat16(), pos_t, 1e4)
    assert got.dtype == torch.bfloat16
    assert row_rel(got.float(), np.asarray(want, np.float32)) <= ROW_REL_BAR


# (name, seq, block, causal, window): windowed has its q tile 3 (rows
# 48-63) meet kv tiles 0 and 1 wholly masked before any live tile, the case
# NEG_INF (and not -inf) keeps finite; seq 16 at the default blocks takes
# the nq == 1 shortcut
ATTN_CASES = [("causal", 64, 16, True, 0), ("windowed", 64, 16, True, 16),
              ("non_causal", 32, 16, False, 0), ("single_tile", 16, 1024, True, 0)]


@pytest.mark.parametrize("name,seq,block,causal,window", ATTN_CASES)
def test_blockwise_attention(name, seq, block, causal, window):
    rng = np.random.default_rng(2)
    inp = {"q": rand(rng, 2, seq, 4, 8), "k": rand(rng, 2, seq, 2, 8),
           "v": rand(rng, 2, seq, 2, 8)}
    kw = dict(causal=causal, window=window, block_q=block, block_k=block)
    out_j, out_t = assert_pair(
        lambda d: ref_common.blockwise_attention(d["q"], d["k"], d["v"], **kw),
        lambda d: common.blockwise_attention(d["q"], d["k"], d["v"], **kw), inp)
    assert np.isfinite(out_t).all()


def test_swiglu():
    rng = np.random.default_rng(3)
    inp = {"x": rand(rng, 2, 5, 16), "g": rand(rng, 16, 32, scale=0.25),
           "u": rand(rng, 16, 32, scale=0.25), "d": rand(rng, 32, 16, scale=0.2)}
    assert_pair(lambda d: ref_common.swiglu(d["x"], d["g"], d["u"], d["d"]),
                lambda d: common.swiglu(d["x"], d["g"], d["u"], d["d"]), inp)


def layer_pair(arch, ref_apply, port_apply, specs, seq=16, batch=2,
               seed=4, **cfg_kw):
    """A layer's (x, params) -> y in both packages, x and every parameter
    differentiated."""
    rcfg = dataclasses.replace(ref_smoke_config(arch), **cfg_kw)
    pcfg = dataclasses.replace(smoke_config(arch), **cfg_kw)
    rng = np.random.default_rng(seed)
    inp = spec_params(specs(pcfg), rng)
    inp["x"] = rand(rng, batch, seq, pcfg.d_model)

    def split(d):
        return d["x"], {k: v for k, v in d.items() if k != "x"}

    def ref_fn(d):
        x, p = split(d)
        return ref_apply(rcfg, p, x)

    def port_fn(d):
        x, p = split(d)
        return port_apply(pcfg, p, x)

    return assert_pair(ref_fn, port_fn, inp, seed)


def test_gqa_apply_with_qkv_bias():
    assert smoke_config("qwen1.5-110b").qkv_bias
    layer_pair("qwen1.5-110b",
               lambda c, p, x: ref_attn.gqa_apply(c, p, x, "train", None, 0, 0)[0],
               lambda c, p, x: attention.gqa_apply(c, p, x, "train", None, 0, 0)[0],
               attention.gqa_specs)


def test_gqa_apply_sliding_window():
    layer_pair("hymba-1.5b",
               lambda c, p, x: ref_attn.gqa_apply(c, p, x, "train", None, 0, 0)[0],
               lambda c, p, x: attention.gqa_apply(c, p, x, "train", None, 0, 0)[0],
               attention.gqa_specs, seq=64, attn_window=8)


def test_mla_apply():
    layer_pair("minicpm3-4b",
               lambda c, p, x: ref_attn.mla_apply(c, p, x, "train", None, 0, 0)[0],
               lambda c, p, x: attention.mla_apply(c, p, x, "train", None, 0, 0)[0],
               attention.mla_specs)


def test_top_k_breaks_ties_by_lower_index():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 4, (64, 16)).astype(np.float32)     # many ties
    vals_j, idx_j = jax.lax.top_k(jnp.asarray(x), 5)
    vals_t, idx_t = moe.top_k(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))


def moe_pair(seed, **cfg_kw):
    """moe_apply's y and aux in both packages; returns (aux_j, aux_t)."""
    rcfg = dataclasses.replace(ref_smoke_config("qwen3-moe-30b-a3b"), **cfg_kw)
    pcfg = dataclasses.replace(smoke_config("qwen3-moe-30b-a3b"), **cfg_kw)
    rng = np.random.default_rng(seed)
    inp = spec_params(moe.moe_specs(pcfg), rng)
    inp["router"][:, 2] = inp["router"][:, 1]   # experts 1 and 2 always tie
    inp["x"] = rand(rng, 2, 16, pcfg.d_model)

    def run(apply, cfg, d):
        p = {k: v for k, v in d.items() if k != "x"}
        return apply(cfg, p, d["x"], mode="train")

    assert_pair(lambda d: run(ref_moe.moe_apply, rcfg, d)[0],
                lambda d: run(moe.moe_apply, pcfg, d)[0], inp, seed)
    aux_j = {k: float(v) for k, v in run(
        ref_moe.moe_apply, rcfg, {k: jnp.asarray(v) for k, v in inp.items()}
    )[1].items()}
    aux_t = {k: float(v) for k, v in run(
        moe.moe_apply, pcfg, {k: torch.from_numpy(v) for k, v in inp.items()}
    )[1].items()}
    assert sorted(aux_j) == sorted(aux_t)
    for k, v in aux_j.items():
        assert abs(aux_t[k] - v) <= TOL * max(1.0, abs(v)), k
    return aux_j, aux_t


def test_moe_apply_with_a_planted_tie():
    moe_pair(6)


def test_moe_apply_drops_over_capacity_like_the_reference():
    aux_j, aux_t = moe_pair(7, capacity_factor=0.5)
    assert aux_j["moe_drop_frac"] > 0.2
    assert aux_t["moe_drop_frac"] == aux_j["moe_drop_frac"]


def test_moe_group_size_and_capacity():
    cfg = smoke_config("qwen3-moe-30b-a3b")
    for n in (1, 32, 512, 1000, 4096, 7 * 97):
        assert moe._group_size(n) == ref_moe._group_size(n)
        assert moe.capacity(cfg, moe._group_size(n)) == \
            ref_moe.capacity(ref_smoke_config("qwen3-moe-30b-a3b"),
                             ref_moe._group_size(n))


def test_ssm_apply_over_two_chunks():
    assert ssm.CHUNK == ref_ssm.CHUNK == 256
    layer_pair("hymba-1.5b",
               lambda c, p, x: ref_ssm.ssm_apply(c, p, x, "train", None)[0],
               lambda c, p, x: ssm.ssm_apply(c, p, x, "train", None)[0],
               ssm.ssm_specs, seq=512, batch=1)


def test_linear_scan_equals_the_sequential_recurrence():
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 3, 4)).astype(np.float32))
    b = torch.from_numpy(rand(rng, 2, 37, 3, 4))
    a_cum, h = ssm.linear_scan(a, b)
    hs, ps = [], []
    cur, prod = torch.zeros_like(b[:, 0]), torch.ones_like(a[:, 0])
    for t in range(a.shape[1]):
        cur = a[:, t] * cur + b[:, t]
        prod = prod * a[:, t]
        hs.append(cur)
        ps.append(prod)
    torch.testing.assert_close(h, torch.stack(hs, 1), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a_cum, torch.stack(ps, 1), rtol=1e-5, atol=1e-6)


def test_mlstm_apply_over_two_chunks():
    layer_pair("xlstm-125m",
               lambda c, p, x: ref_xlstm.mlstm_apply(c, p, x, "train", None)[0],
               lambda c, p, x: xlstm.mlstm_apply(c, p, x, "train", None)[0],
               xlstm.mlstm_specs, seq=512, batch=1)


def test_slstm_apply():
    layer_pair("xlstm-125m",
               lambda c, p, x: ref_xlstm.slstm_apply(c, p, x, "train", None)[0],
               lambda c, p, x: xlstm.slstm_apply(c, p, x, "train", None)[0],
               xlstm.slstm_specs)


@pytest.mark.parametrize("masked", [False, True, "none_kept"])
def test_softmax_xent(masked):
    rng = np.random.default_rng(9)
    labels = rng.integers(0, 32, (2, 8)).astype(np.int32)
    mask = None
    if masked:
        mask = rng.random((2, 8)) < 0.4 if masked is True else np.zeros((2, 8), bool)
    mj = None if mask is None else jnp.asarray(mask)
    mt = None if mask is None else torch.from_numpy(mask)
    out_j, out_t = assert_pair(
        lambda d: ref_common.softmax_xent(d["logits"], jnp.asarray(labels), mj),
        lambda d: common.softmax_xent(d["logits"], torch.from_numpy(labels), mt),
        {"logits": rand(rng, 2, 8, 32, scale=3.0)})
    if masked == "none_kept":
        assert float(out_t) == 0.0
