"""The port's rmsnorm op against the JAX package's, on the CPU.

The same numpy inputs (made from a seed, cast to bf16 the same way in both
packages) go through the JAX ``api.call("rmsnorm")``, which runs its Pallas
kernel in interpret mode here, and the port's ``api.call``, which runs the
kernel's plain PyTorch version on CPU tensors; they agree within the op's
``tol`` (1e-1, one bf16 ulp of the largest outputs), and the two plain
versions agree within 1e-5 in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import api as japi
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jref
from repro.models.common import rms_norm as model_rms_norm
from repro_torch.kernels import api
from repro_torch.kernels.rmsnorm import ops as tops
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}


def _inputs(r, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(r, d).astype(np.float32),
            rng.randn(d).astype(np.float32))


def _both(a, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("r,d", [(256, 128), (96, 64), (64, 1024)])
def test_call_matches_jax_kernel(r, d, dtype):
    x, sc = _inputs(r, d, r + d)
    jx, tx = _both(x, dtype)
    jsc, tsc = _both(sc, dtype)
    want = japi.call("rmsnorm", jx, jsc, eps=1e-6)
    got = api.call("rmsnorm", tx, tsc, eps=1e-6)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert np.abs(_np(got) - _np(want)).max() <= api.get_op("rmsnorm").tol


def test_ref_matches_jax_ref_f32():
    x, sc = _inputs(128, 256, 7)
    got = rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(sc), 1e-5)
    want = jref(jnp.asarray(x), jnp.asarray(sc), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_matches_model_rms_norm():
    """As tests/test_kernels.py holds the JAX kernel to the model's norm."""
    x, sc = _inputs(64, 64, 15)
    jx, tx = _both(x, "bfloat16")
    jsc, tsc = _both(sc, "bfloat16")
    got = rmsnorm(tx, tsc)
    assert np.abs(_np(got) - _np(model_rms_norm(jx, jsc))).max() < 1e-1


def test_leading_dims_flatten_like_jax():
    x, sc = _inputs(24, 64, 3)
    tx = torch.from_numpy(x).reshape(2, 3, 4, 64)
    got = rmsnorm(tx, torch.from_numpy(sc))
    assert got.shape == (2, 3, 4, 64)
    assert torch.equal(got.reshape(24, 64),
                       rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(sc)))


def test_every_block_rows_gives_the_same_bits():
    x, sc = _inputs(96, 128, 11)
    tx, tsc = torch.from_numpy(x).to(torch.bfloat16), \
        torch.from_numpy(sc).to(torch.bfloat16)
    op = api.get_op("rmsnorm")
    axes = api.clamped_axes(op, tx, tsc)
    assert axes == {"block_rows": (32, 96)}
    outs = [op.run({"block_rows": br}, tx, tsc) for br in axes["block_rows"]]
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_registry_entry_matches_jax():
    op, jop = api.get_op("rmsnorm"), japi.get_op("rmsnorm")
    assert op.tol == jop.tol
    assert op.exact_axes == jop.exact_axes
    assert dict(op.axes) == dict(jop.axes)
    assert dict(op.default) == dict(jop.default)
    assert tops.BLOCK_ROWS_CANDIDATES == op.axes["block_rows"]
    for dtype in DTYPES:
        x, sc = _inputs(512, 1024, 0)
        (jx, tx), (jsc, tsc) = _both(x, dtype), _both(sc, dtype)
        assert op.shape_key(tx, tsc) == jop.shape_key(jx, jsc)
    assert op.shape_key(tx, tsc) == "r512d1024:float32"
