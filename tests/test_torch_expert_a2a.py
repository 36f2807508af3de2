"""The ``expert_a2a`` registry op against the JAX package's.

The op quantizes the MoE dispatch buffers ``(g, e, c, d)`` blockwise
along d, lays the s8 values and f32 scales out over the experts axis and
dequantizes. On the same bf16 inputs (seeded numpy, every candidate
block), the port's quantizer gives the reference's s8 values and scales
bit for bit, and the op's output equals the reference's jitted op bit for
bit (the dequantize is one f32 product per element in both, then one
rounding to bf16); against its bf16 ``ref`` it stays within the op's
``tol`` of 5e-2 (measured 1.95e-2 and 1.56e-2 on unit normals whose
largest value is 4.4 and 3.7: half an int8 step of the block's amax,
4.4/127/2, plus a bf16 rounding). The op's
axes, default, clamp and shape key are the reference's, and the registry
lists the reference's six ops. MoE decode under the int8 transport goes
through it once per layer per step, on one device; its tokens equal the
reference's (``tests/test_torch_serve.py::
test_moe_int8_act_decode_waits_for_expert_a2a``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import collectives as ref_coll
from repro.kernels import api as ref_api
from repro.kernels.expert_a2a import ops as ref_ops
from repro_torch.configs import smoke_config
from repro_torch.dist import collectives as coll
from repro_torch.kernels import api
from repro_torch.kernels.expert_a2a import EP_AXES
from repro_torch.kernels.expert_a2a import ops
from repro_torch.launch.serve import grow_cache
from repro_torch.models import transformer
from repro_torch.train import step as step_lib

SHAPES = ((2, 4, 16, 256), (1, 8, 4, 96))


def dispatch(shape, seed=0) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal(shape, np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def as_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.copy()).to(torch.bfloat16)


def bits(t) -> np.ndarray:
    return np.asarray(t).view(np.uint16 if np.asarray(t).itemsize == 2
                              else np.uint32)


def test_registry_lists_the_references_six_ops():
    ref_api.ensure_registered()
    assert set(api.ops()) == set(ref_api._REGISTRY) == {
        "compact_pack", "rmsnorm", "decode_attn", "paged_attn",
        "flash_attn", "expert_a2a"}


def test_op_declares_the_references_space():
    op, ref = api.get_op("expert_a2a"), ref_api.get_op("expert_a2a")
    assert dict(op.axes) == {k: tuple(v) for k, v in ref.axes.items()}
    assert dict(op.default) == dict(ref.default) == {"block": 256}
    assert op.tol == ref.tol == 5e-2
    assert EP_AXES == ref_ops.EP_AXES
    for shape in SHAPES:
        x = dispatch(shape)
        assert op.shape_key(as_torch(x)) == \
            ref.shape_key(jnp.asarray(x, jnp.bfloat16))
        for blk in op.axes["block"]:
            assert op.clamp({"block": blk}, as_torch(x)) == \
                ref.clamp({"block": blk}, jnp.asarray(x, jnp.bfloat16))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("block", [64, 128, 256, 512])
def test_quantizer_and_op_equal_the_reference_bit_for_bit(shape, block):
    x = dispatch(shape, seed=block)
    xj, xt = jnp.asarray(x, jnp.bfloat16), as_torch(x)
    op = api.get_op("expert_a2a")
    point = op.clamp({"block": block}, xt)
    # jitted, as the op runs it (XLA multiplies by 1/127, as the port does)
    q_w, s_w = jax.jit(ref_coll.quantize_int8_lastdim,
                       static_argnums=1)(xj, point["block"])
    q_g, s_g = coll.quantize_int8_lastdim(xt, point["block"])
    assert np.array_equal(np.asarray(q_w), q_g.numpy())
    assert np.array_equal(bits(np.asarray(s_w)), bits(s_g.numpy()))
    want = ref_api.call("expert_a2a", xj, point=point)
    got = api.call("expert_a2a", xt, point=point)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    assert np.array_equal(bits(np.asarray(want)),
                          bits(got.view(torch.int16).numpy()))


@pytest.mark.parametrize("shape", SHAPES)
def test_op_within_tol_of_the_bf16_dispatch(shape):
    xt = as_torch(dispatch(shape, seed=1))
    got = ops.expert_a2a(xt)
    ref = ops.expert_a2a(xt, use_ref=True)
    assert torch.equal(ref, xt)            # off a mesh: the identity
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= api.get_op("expert_a2a").tol, err


def test_example_builds_on_the_host():
    (xe,), kw = api.get_op("expert_a2a").example(True, device="cpu")
    assert xe.shape == (2, 4, 16, 256) and xe.dtype == torch.bfloat16
    assert kw == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.get_op("expert_a2a").example(True)


def test_moe_int8_decode_calls_it_once_per_layer():
    cfg = smoke_config("qwen3-moe-30b-a3b")
    params = transformer.init_params(cfg, seed=0, device="cpu")
    prefill = step_lib.make_prefill_step(cfg, "int8")
    tok = torch.zeros((2, 4), dtype=torch.int32)
    logits, cache = prefill(params, {"tokens": tok})
    cache = grow_cache(cache, transformer.abstract_cache(cfg, 2, 6))
    ops.reset_calls()
    decode = step_lib.make_decode_step(cfg, 6, "int8")
    decode(params, cache, {"tokens": tok[:, :1], "pos": torch.tensor(4)})
    assert ops.calls() == cfg.n_layers
    ops.reset_calls()
    step_lib.make_decode_step(cfg, 6, "bf16")(
        params, cache, {"tokens": tok[:, :1], "pos": torch.tensor(4)})
    assert ops.calls() == 0
