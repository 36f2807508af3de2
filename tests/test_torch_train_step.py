"""The port's train step against the JAX package's, jitted, on the CPU.

Three families at their ``smoke_config`` -- ``paper-lm-100m`` (dense),
``qwen3-moe-30b-a3b`` (MoE) and ``xlstm-125m`` -- with the reference's
``init_params`` weights carried across by ``params_from_jax`` and cast to
f32 on both sides, each for microbatches 1 and 2 and transports ``bf16``
and ``int8_ef``, three steps of the same numpy batches (4 x 16 tokens from
a seed) under the launcher's AdamW with a warm-up of 2.

The weights are f32 because bf16 gradients differ between the frameworks
by 1-7% of a leaf's scale (XLA keeps f32 across fused chains; see
``test_torch_models.py``), which would swamp the update being compared.

Bars, each about 4x over what was measured:
  * losses and metrics at every step within 2e-6 x max(1, |value|)
    (measured under 7e-7), ``grad_norm`` within 3e-5 relative (5.2e-6),
    ``lr`` bit-equal;
  * parameters after the last step: every element within a quarter of the
    summed learning rate (measured 0.058 of it), and at most 1e-3 of all
    elements beyond 1e-2 of it (measured 2.4e-4). Adam's first update is
    about ``lr x sign(g)``, so an element whose gradient is near the
    frameworks' rounding noise (|g| ~ eps, or an int8 value on a rounding
    tie) can move by up to its whole update in one package and not in the
    other; elsewhere the updates agree to far better than 1e-2 of lr.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import transformer as ref_tf
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch.configs import smoke_config
from repro_torch.models import params_from_jax
from repro_torch.models.common import tree_leaves
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_lib

ARCHS = ("paper-lm-100m", "qwen3-moe-30b-a3b", "xlstm-125m")
ADAMW = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 30}
STEPS, BATCH, SEQ = 3, 4, 16
METRIC_TOL, GNORM_TOL = 2e-6, 3e-5
PARAM_ALL, PARAM_MOST, PARAM_FRAC = 0.25, 1e-2, 1e-3


def batches(vocab: int):
    rng = np.random.default_rng(1)
    for _ in range(STEPS):
        tok = rng.integers(0, vocab, (BATCH, SEQ + 1), dtype=np.int32)
        yield {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def f32_weights(arch: str):
    rp = ref_tf.init_params(ref_smoke_config(arch), jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if a.dtype == jnp.bfloat16 else a, rp)


@pytest.mark.parametrize("transport", ["bf16", "int8_ef"])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jitted_reference(arch, microbatches, transport):
    cfg = smoke_config(arch)
    rp = f32_weights(arch)
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, rp), device="cpu")
    ef = transport == "int8_ef"
    ro, to = ref_opt.init_state(rp, error_feedback=ef), \
        opt.init_state(tp, error_feedback=ef)
    rstep = jax.jit(ref_step.make_train_step(
        ref_smoke_config(arch), ref_opt.AdamWConfig(**ADAMW),
        microbatches=microbatches, grad_transport=transport))
    tstep = step_lib.make_train_step(
        cfg, opt.AdamWConfig(**ADAMW), microbatches=microbatches,
        grad_transport=transport)
    for i, nb in enumerate(batches(cfg.vocab)):
        rp, ro, rm = rstep(rp, ro, {k: jnp.asarray(v) for k, v in nb.items()})
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v)
                                    for k, v in nb.items()})
        assert sorted(tm) == sorted(rm), (sorted(tm), sorted(rm))
        for k in rm:
            want, got = float(rm[k]), float(tm[k])
            if k == "lr":
                assert got == want, (i, got, want)
                continue
            tol = GNORM_TOL if k == "grad_norm" else METRIC_TOL
            assert abs(got - want) <= tol * max(1.0, abs(want)), \
                (i, k, got, want)
    assert int(to["step"]) == STEPS
    if ef:
        assert all(bool((e != 0).any()) for e in tree_leaves(to["ef"]))

    lr_sum = sum(float(ref_opt.lr_schedule(ref_opt.AdamWConfig(**ADAMW),
                                           jnp.int32(s + 1)))
                 for s in range(STEPS))
    errs = [np.abs(t.float().numpy() - np.asarray(r, np.float32)).reshape(-1)
            for r, t in zip(jax.tree.leaves(rp), tree_leaves(tp))]
    assert len(errs) == len(jax.tree.leaves(rp))
    err = np.concatenate(errs) / lr_sum
    assert err.max() <= PARAM_ALL, err.max()
    assert (err > PARAM_MOST).mean() <= PARAM_FRAC, (err > PARAM_MOST).mean()


CFG = smoke_config("paper-lm-100m")


def test_int8_ef_without_ef_state_raises():
    params = params_from_jax(CFG, jax.tree.map(
        np.asarray, f32_weights("paper-lm-100m")), device="cpu")
    step = step_lib.make_train_step(CFG, opt.AdamWConfig(),
                                    grad_transport="int8_ef")
    nb = next(batches(CFG.vocab))
    with pytest.raises(KeyError):
        step(params, opt.init_state(params),
             {k: torch.from_numpy(v) for k, v in nb.items()})


def test_unknown_transport_rejected():
    with pytest.raises(ValueError):
        step_lib.make_train_step(CFG, opt.AdamWConfig(), grad_transport="fp4")


def test_mesh_step_waits_for_multi_gpu():
    """``mesh=`` gives the data-parallel step, held across ranks in
    ``test_torch_dp_step.py``. On the one-process mesh, a data axis of
    one, it trains on the whole batch: its loss is the one-device
    step's."""
    from repro_torch.launch.mesh import make_local_mesh

    params = params_from_jax(CFG, jax.tree.map(
        np.asarray, f32_weights("paper-lm-100m")), device="cpu")
    nb = {k: torch.from_numpy(v) for k, v in next(batches(CFG.vocab)).items()}
    one = step_lib.make_train_step(CFG, opt.AdamWConfig())
    dp = step_lib.make_train_step(CFG, opt.AdamWConfig(),
                                  mesh=make_local_mesh(device="cpu"))
    want = one(params, opt.init_state(params), nb)[2]
    got = dp(params, opt.init_state(params), nb)[2]
    assert float(got["loss"]) == float(want["loss"])


def test_split_microbatches_matches_reference():
    nb = {"tokens": np.arange(4 * 6, dtype=np.int32).reshape(4, 6),
          "labels": np.arange(4 * 6, dtype=np.int32).reshape(4, 6) + 1}
    want = ref_step._split_microbatches(
        {k: jnp.asarray(v) for k, v in nb.items()}, 2)
    got = step_lib._split_microbatches(
        {k: torch.from_numpy(v) for k, v in nb.items()}, 2)
    for k in nb:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
