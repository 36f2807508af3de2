"""The port's sLSTM sequence, a ``torch.autograd.Function`` with the
reference's deferred recurrent-weight-gradient backward, against plain
autograd through the per-step cell and against the JAX custom VJP
(``src/repro/models/xlstm.py:253-344``), over the hypothesis ranges of
``tests/test_xlstm_vjp.py``. Bars: the value within 1e-5 and each gradient
within 1e-4, those of ``tests/test_xlstm_vjp.py``; against JAX, within
1e-5 x the gradient's scale + 1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings, strategies as st
from torch.utils.checkpoint import checkpoint

from repro.models import xlstm as ref_xlstm
from repro_torch.models.xlstm import _slstm_cell_raw, _slstm_sequence


def inputs(S, B, H, d, seed):
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal((4, H, d // H, d // H)) * 0.1).astype(np.float32)
    bg = (rng.standard_normal((4, d)) * 0.1).astype(np.float32)
    gx = rng.standard_normal((S, B, 4, d)).astype(np.float32)
    # a state a sequence could leave: h, c of either sign, the normalizer
    # n positive, the running max m at 0
    s0 = (rng.standard_normal((4, B, d)) * 0.5).astype(np.float32)
    s0[2] = rng.uniform(0.5, 1.5, (B, d))
    s0[3] = 0.0
    return r, bg, gx, s0


def objective(ys, final):
    return (ys ** 2).sum() + sum(f.sum() for f in final)


def torch_grads(seq_fn, H, r, bg, gx, s0):
    """Value and gradients of (r, bg, gx, state0) through ``seq_fn``."""
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in (r, bg, gx)]
    st0 = [torch.from_numpy(s.copy()).requires_grad_() for s in s0]
    ys, final = seq_fn(H, *ts, tuple(st0))
    val = objective(ys, final)
    val.backward()
    return float(val.detach()), [t.grad.numpy() for t in ts + st0]


def plain_sequence(H, r, bg, gx, state0):
    """The same sequence through autograd of the per-step cell."""
    state, ys = state0, []
    for t in range(gx.shape[0]):
        state = _slstm_cell_raw(H, r, bg, gx[t], state)
        ys.append(state[0])
    return torch.stack(ys), state


@given(st.integers(min_value=1, max_value=16),
       st.integers(min_value=1, max_value=4),
       st.sampled_from([(1, 4), (2, 8), (4, 16)]),
       st.integers(min_value=0, max_value=100))
@settings(max_examples=12, deadline=None)
def test_function_matches_plain_autograd(S, B, Hd, seed):
    H, d = Hd
    args = inputs(S, B, H, d, seed)
    v1, g1 = torch_grads(plain_sequence, H, *args)
    v2, g2 = torch_grads(_slstm_sequence, H, *args)
    assert abs(v1 - v2) < 1e-5 * max(1.0, abs(v1))
    for a, b in zip(g1, g2):
        assert float(np.abs(a - b).max()) < 1e-4


@given(st.integers(min_value=1, max_value=16),
       st.integers(min_value=1, max_value=4),
       st.sampled_from([(1, 4), (2, 8), (4, 16)]),
       st.integers(min_value=0, max_value=100))
@settings(max_examples=12, deadline=None)
def test_function_matches_the_jax_custom_vjp(S, B, Hd, seed):
    """Gradients of the weights, the gate inputs and the initial state
    (the cotangent ``_slstm_seq_bwd`` returns for ``state0``)."""
    H, d = Hd
    r, bg, gx, s0 = inputs(S, B, H, d, seed)

    def ref(r, bg, gx, s0):
        ys, final = ref_xlstm._slstm_sequence(H, r, bg, gx, tuple(s0))
        return jnp.sum(ys ** 2) + sum(jnp.sum(f) for f in final)

    val, grads = jax.value_and_grad(ref, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (r, bg, gx, s0)))
    want = [np.asarray(g) for g in grads[:3]] + list(np.asarray(grads[3]))
    v, got = torch_grads(_slstm_sequence, H, r, bg, gx, s0)
    assert abs(v - float(val)) <= 1e-5 * max(1.0, abs(float(val)))
    for a, b in zip(got, want):
        assert float(np.abs(a - b).max()) <= 1e-5 * float(np.abs(b).max()) + 1e-6


def test_function_under_checkpoint_and_in_bf16():
    """Recomputed under non-reentrant checkpoint, as each xLSTM block is,
    the gradients are those of the direct call; bf16 gate inputs get bf16
    gradients, as the reference casts ``dxs`` to the inputs' dtype."""
    r, bg, gx, s0 = inputs(6, 2, 2, 8, 0)
    direct = torch_grads(_slstm_sequence, 2, r, bg, gx, s0)
    remat = torch_grads(
        lambda *a: checkpoint(_slstm_sequence, *a, use_reentrant=False),
        2, r, bg, gx, s0)
    assert direct[0] == remat[0]
    for a, b in zip(direct[1], remat[1]):
        np.testing.assert_array_equal(a, b)
    gxb = torch.from_numpy(gx).bfloat16().requires_grad_()
    zeros = torch.zeros(2, 8)
    ys, _ = _slstm_sequence(2, torch.from_numpy(r), torch.from_numpy(bg), gxb,
                            (zeros,) * 4)
    (ys ** 2).sum().backward()
    assert ys.dtype == torch.float32 and gxb.grad.dtype == torch.bfloat16
