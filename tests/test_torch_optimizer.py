"""The port's AdamW, learning-rate schedule and int8 quantizers against the
JAX package's, jitted, on the CPU.

``lr_schedule``: every step from 0 to ``total_steps + 50``; bar 1 f32 ulp,
and the test counts the exact matches. It finds all of them exact: XLA
turns each division by a constant into a product with its f32 reciprocal,
folds ``0.9 * 0.5``, fuses ``0.45 * (1 + cos) + 0.1`` into one rounding
and calls glibc's ``cosf``, and the port does each of these.

``apply_updates``: five updates of a tree of f32 and bf16 parameters with
f32 and bf16 gradients, the clip binding on the third. ``mu`` and ``nu``
within 2e-6 of each leaf's largest magnitude, f32 parameters within 2e-6
of theirs (XLA fuses the update's chain, eager torch rounds each op:
measured under 2e-7), bf16 parameters within 1 bf16 ulp of the value;
``lr`` bit-equal, ``grad_norm`` within 1e-6 relative.

The int8 quantizers and ``compressed_psum``: bit-exact, outputs and
residuals, on all-zero blocks, padded tails, values on the ``.5``
rounding ties and tiny values whose residuals stay normal (XLA on the CPU
flushes subnormals to zero, eager torch keeps them).
"""

from __future__ import annotations

import ctypes
import ctypes.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import collectives as ref_coll
from repro.train import optimizer as ref_opt
from repro_torch.dist import collectives as coll
from repro_torch.models.interop import to_torch
from repro_torch.train import optimizer as opt

CONFIGS = {
    "default": {},
    "launcher": {"lr": 1e-3, "warmup_steps": 10, "total_steps": 60},
    "runner-tests": {"lr": 1e-3, "warmup_steps": 2, "total_steps": 30},
    "no-warmup": {"lr": 3e-3, "warmup_steps": 0, "total_steps": 1000},
}


def f32_bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32).astype(np.int64)


def bits_of(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy().view({1: np.int8, 2: np.int16, 4: np.int32}[t.element_size()])


def ref_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


# ------------------------------------------------------------ lr_schedule
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_lr_schedule_matches_jitted_reference(name):
    kw = CONFIGS[name]
    rcfg, cfg = ref_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    steps = np.arange(rcfg.total_steps + 51, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda s: ref_opt.lr_schedule(rcfg, s)))(steps))
    got = opt.lr_schedule(cfg, torch.from_numpy(steps)).numpy()
    ulps = np.abs(f32_bits(got) - f32_bits(want))
    assert ulps.max() <= 1, (name, int(ulps.max()), steps[ulps.argmax()])
    exact = int((ulps == 0).sum())
    assert exact == len(steps), f"{name}: {exact} of {len(steps)} exact"


def test_cosf_is_glibc_cosf_as_xla_calls_it():
    """XLA's f32 cosine on the CPU is glibc's ``cosf``, and the port's
    ``_cosf`` computes it bit for bit: over the schedule's arguments
    [0, pi], small ones, and a wider signed range."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.cosf.restype, libm.cosf.argtypes = ctypes.c_float, [ctypes.c_float]
    rng = np.random.default_rng(4)
    y = np.concatenate([
        np.linspace(0, np.pi, 20001, dtype=np.float32),
        np.float32([0.0, 1e-30, 2.0 ** -13, 2.0 ** -12, 0.7499999, 0.75,
                    np.pi / 4, np.pi / 2, np.pi]),
        rng.uniform(0, 1e-3, 2000).astype(np.float32),
        rng.uniform(-100, 100, 2000).astype(np.float32)])
    glibc = np.array([libm.cosf(float(v)) for v in y], np.float32)
    xla = np.asarray(jax.jit(jnp.cos)(y))
    assert np.array_equal(xla.view(np.int32), glibc.view(np.int32))
    port = opt._cosf(torch.from_numpy(y)).numpy()
    assert np.array_equal(port.view(np.int32), glibc.view(np.int32))


def test_lr_schedule_scalar_step_on_its_device():
    cfg = opt.AdamWConfig(**CONFIGS["launcher"])
    lr = opt.lr_schedule(cfg, torch.tensor(5, dtype=torch.int32))
    assert lr.shape == () and lr.dtype == torch.float32
    want = ref_opt.lr_schedule(ref_opt.AdamWConfig(**CONFIGS["launcher"]),
                               jnp.int32(5))
    assert float(lr) == float(want)


# ----------------------------------------------------------- apply_updates
SHAPES = {"a": (32, 16), "b": (16,), "c": (8, 4, 8)}


def make_tree(rng, dtypes):
    return {k: rng.standard_normal(SHAPES[k]).astype(np.float32) * 0.5
            for k in dtypes}


def as_jax(tree, dtypes):
    return {k: jnp.asarray(v).astype(dtypes[k]) for k, v in tree.items()}


def as_torch(tree, dtypes):
    """The same values, rounded to each leaf's dtype, as tensors."""
    return {k: to_torch(np.asarray(jnp.asarray(v).astype(dtypes[k])),
                        torch.device("cpu"))
            for k, v in tree.items()}


@pytest.mark.parametrize("param_dtype,grad_dtype", [
    ("f32", "f32"), ("f32", "bf16"), ("bf16", "f32"), ("bf16", "bf16"),
    ("mixed", "bf16")])
def test_apply_updates_matches_jitted_reference(param_dtype, grad_dtype):
    dt = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    if param_dtype == "mixed":
        pdt = {"a": jnp.bfloat16, "b": jnp.float32, "c": jnp.bfloat16}
    else:
        pdt = {k: dt[param_dtype] for k in SHAPES}
    gdt = {k: dt[grad_dtype] for k in SHAPES}
    kw = {"lr": 1e-2, "warmup_steps": 2, "total_steps": 8}
    rcfg, cfg = ref_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    p0 = make_tree(rng, SHAPES)
    rp, tp = as_jax(p0, pdt), as_torch(p0, pdt)
    rs, ts = ref_opt.init_state(rp), opt.init_state(tp)
    upd = jax.jit(lambda p, g, s: ref_opt.apply_updates(rcfg, p, g, s))
    clipped = 0
    for i in range(5):
        # global norm ~0.28, and ~11 on the third update: the clip binds
        g = {k: v * (0.8 if i == 2 else 0.02)
             for k, v in make_tree(rng, SHAPES).items()}
        rp, rs, rm = upd(rp, as_jax(g, gdt), rs)
        tp, ts, tm = opt.apply_updates(cfg, tp, as_torch(g, gdt), ts)
        clipped += float(rm["grad_norm"]) > cfg.grad_clip
        assert int(ts["step"]) == int(rs["step"]) == i + 1
        assert ts["step"].dtype == torch.int32
        assert bits_of(tm["lr"]).item() == ref_bits(rm["lr"]).item()
        gn, rgn = float(tm["grad_norm"]), float(rm["grad_norm"])
        assert abs(gn - rgn) <= 1e-6 * rgn, (i, gn, rgn)
        for k in SHAPES:
            for name in ("mu", "nu"):
                want = np.asarray(rs[name][k])
                got = ts[name][k].numpy()
                scale = float(np.abs(want).max())
                assert np.abs(got - want).max() <= 2e-6 * scale, \
                    (i, name, k, np.abs(got - want).max() / scale)
            want = np.asarray(rp[k]).astype(np.float32)
            got = tp[k].float().numpy()
            assert tp[k].dtype == (torch.bfloat16 if pdt[k] == jnp.bfloat16
                                   else torch.float32)
            if pdt[k] == jnp.bfloat16:
                ulp = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
                assert (np.abs(got - want) <= ulp).all(), (i, k)
            else:
                scale = float(np.abs(want).max())
                assert np.abs(got - want).max() <= 2e-6 * scale, (i, k)
    assert clipped == 1


def test_init_state_and_axes():
    params = {"w": torch.zeros((3, 4), dtype=torch.bfloat16),
              "b": [torch.ones(5)]}
    st = opt.init_state(params, error_feedback=True)
    assert st["mu"]["w"].dtype == torch.float32
    assert st["mu"]["w"].shape == (3, 4) and st["nu"]["b"][0].shape == (5,)
    assert st["ef"]["w"].shape == (3, 4)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    per_dev = opt.init_state(params, error_feedback=True, ef_devices=4)
    assert per_dev["ef"]["w"].shape == (4, 3, 4)
    assert "ef" not in opt.init_state(params)
    axes = {"w": ("embed", "mlp"), "b": [("mlp",)]}
    assert opt.state_axes(axes) == ref_opt.state_axes(axes)
    assert opt.state_axes(axes, True) == ref_opt.state_axes(axes, True)


# ---------------------------------------------- the int8 quantizers, bits
def tie_blocks(block: int) -> np.ndarray:
    """Blocks whose abs-max is 127, so the scale is exactly 1.0 and every
    value k + 0.5 is a rounding tie (half to even: 0.5 -> 0, 1.5 -> 2)."""
    rng = np.random.default_rng(3)
    k = rng.integers(-126, 126, size=(4, block)).astype(np.float32)
    x = k + 0.5
    x[:, 0] = 127.0
    x[1, 0] = -127.0
    return x


def cases():
    rng = np.random.default_rng(1)
    wide = (rng.standard_normal(5000)
            * np.exp(rng.standard_normal(5000) * 3)).astype(np.float32)
    zeros_mid = wide.copy()
    zeros_mid[256:768] = 0.0                     # two all-zero blocks
    return {
        "lognormal": wide,
        "zero-blocks": zeros_mid,
        "all-zero": np.zeros(700, np.float32),
        "padded-tail": wide[:1000],              # 1000 = 3 x 256 + 232
        "ties": tie_blocks(256).reshape(-1),
        # values and residuals stay normal: XLA on the CPU flushes
        # subnormals to zero, eager torch keeps them
        "tiny": np.float32([1.5e-38, -1e-37, 0.0, 1e-20]),
    }


CASES = cases()


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("block", [256, 64])
def test_quantize_int8_bit_exact(name, block):
    x = CASES[name]
    rq, rs = jax.jit(lambda a: ref_coll.quantize_int8(a, block))(x)
    q, s = coll.quantize_int8(torch.from_numpy(x), block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert np.array_equal(bits_of(s), ref_bits(rs))
    rd = jax.jit(lambda a, b: ref_coll.dequantize_int8(a, b, x.size))(rq, rs)
    d = coll.dequantize_int8(q, s, x.size)
    assert np.array_equal(bits_of(d), ref_bits(rd))
    if name == "ties":
        r = torch.from_numpy(x).reshape(-1, block) / s[:, None]
        assert bool((torch.frac(r).abs() == 0.5).any())


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_err", [False, True])
def test_compressed_psum_bit_exact(name, dtype, with_err):
    x = CASES[name].reshape(-1)
    if x.size % 10 == 0:
        x = x.reshape(10, -1)                  # a 2-D leaf
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    xj = jnp.asarray(x).astype(jdt)
    err = (np.random.default_rng(2).standard_normal(x.shape)
           .astype(np.float32) * 1e-2) if with_err else None
    fn = jax.jit(lambda a, e: ref_coll.compressed_psum(a, None, e))
    ro, re = fn(xj, None if err is None else jnp.asarray(err))
    xt = to_torch(np.asarray(xj), torch.device("cpu"))
    o, e = coll.compressed_psum(
        xt, None, None if err is None else torch.from_numpy(err))
    assert o.dtype == xt.dtype and o.shape == xt.shape
    assert e.dtype == torch.float32 and e.shape == xt.shape
    assert np.array_equal(bits_of(o), ref_bits(ro))
    assert np.array_equal(bits_of(e), ref_bits(re))


def test_compressed_psum_over_an_axis_waits_for_multi_gpu():
    """An axis now names a mesh dim: outside any mesh it is an error; the
    exchange itself is held in test_torch_collectives_ranks.py."""
    with pytest.raises(ValueError, match="names no mesh"):
        coll.compressed_psum(torch.ones(4), "data")
