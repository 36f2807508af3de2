"""The explicit data-parallel train step across ranks against the JAX
package's ``_data_parallel_step``.

The reference runs once in a JAX subprocess on 4 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as its own
multi-device suite runs), a ``shard_map`` over a ``(4,)`` data mesh,
jitted, and writes every step's metrics and the final parameters and
residuals to an ``.npz``. The port runs on 4 gloo ranks on the CPU, one
spawned group for both transports. Both start from the reference's
``init_params`` weights of smoke ``paper-lm-100m`` cast to f32, and take 3
steps of the same 8 x 16 global batches from a seed (2 rows a rank) under
the launcher's AdamW with a warm-up of 2.

Bars, set about 4x over what was measured here:
  * the loss at every step within 2e-5 x max(1, |loss|) under ``bf16``
    (measured 4.3e-6) and 2e-6 under ``int8_ef`` (8.5e-8); ``grad_norm``
    within 3e-4 relative under ``bf16`` (6.8e-5) and 3e-5 under
    ``int8_ef`` (9.1e-7); ``lr`` bit-equal. The ``bf16`` arm is looser
    because its reduction rounds differently: gloo sums the bf16 gradients
    pairwise, rounding to bf16 at every add, while XLA's CPU all-reduce
    sums them in f32 and rounds once, so a reduced gradient can differ by
    a bf16 ulp and steps 2-3 start from slightly different weights;
  * parameters after the last step: under ``int8_ef`` within a quarter of
    the summed learning rate everywhere (measured 0.020 of it) and beyond
    1e-2 of it on at most 1e-3 of the elements (4.4e-5), as
    ``test_torch_train_step.py`` holds the one-device step; under ``bf16``
    within the summed learning rate itself (measured 0.40 of it: Adam
    moves an element by at most about ``lr`` a step, and an element whose
    reduced gradient changed sign by an ulp moves the other way) and
    beyond 1e-2 of it on at most 1e-2 of the elements (1.9e-3);
  * each rank's ``(1, *shape)`` residual row against the reference's row
    of its device: within 1e-2 of the leaf's largest residual on all but
    2e-3 of the elements (measured 3.5e-4: a rounding tie moves one
    element's residual by a whole quantization step).
The counted int8_ef wire bytes are fewer than bf16's.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import transformer as ref_tf
from repro.train import optimizer as ref_opt
from repro_torch.configs import smoke_config
from repro_torch.dist import collectives as coll
from repro_torch.dist.spawn import run_ranks
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import params_from_jax
from repro_torch.models.common import tree_leaves
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_lib

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH, W = "paper-lm-100m", 4
ADAMW = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 30}
STEPS, BATCH, SEQ = 3, 8, 16
LOSS_TOL = {"bf16": 2e-5, "int8_ef": 2e-6}
GNORM_TOL = {"bf16": 3e-4, "int8_ef": 3e-5}
PARAM_ALL = {"bf16": 1.0, "int8_ef": 0.25}
PARAM_MOST = 1e-2
PARAM_FRAC = {"bf16": 1e-2, "int8_ef": 1e-3}
EF_MOST, EF_FRAC = 1e-2, 2e-3
GROUP_S = 150

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import smoke_config
    from repro.models import transformer
    from repro.train import optimizer as opt, step as step_lib
    arch, out_path = sys.argv[1], sys.argv[2]
    adamw = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30)
    cfg = smoke_config(arch)
    params = jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        transformer.init_params(cfg, jax.random.PRNGKey(0)))
    mesh = jax.make_mesh((4,), ("data",))
    rng = np.random.default_rng(1)
    batches = []
    for _ in range({steps}):
        tok = rng.integers(0, cfg.vocab, ({batch}, {seq} + 1), dtype=np.int32)
        batches.append({{"tokens": tok[:, :-1], "labels": tok[:, 1:]}})
    out = {{}}
    for t in ("bf16", "int8_ef"):
        ef = t == "int8_ef"
        o = opt.init_state(params, error_feedback=ef,
                           ef_devices=4 if ef else None)
        fn = jax.jit(step_lib.make_train_step(cfg, adamw, grad_transport=t,
                                              mesh=mesh))
        p = params
        for i, b in enumerate(batches):
            p, o, m = fn(p, o, {{k: jnp.asarray(v) for k, v in b.items()}})
            for k, v in m.items():
                out[f"{{t}}/m/{{i}}/{{k}}"] = np.asarray(v)
        for j, leaf in enumerate(jax.tree.leaves(p)):
            out[f"{{t}}/p/{{j}}"] = np.asarray(leaf)
        if ef:
            for j, leaf in enumerate(jax.tree.leaves(o["ef"])):
                out[f"{{t}}/ef/{{j}}"] = np.asarray(leaf)
    np.savez(out_path, **out)
""").format(steps=STEPS, batch=BATCH, seq=SEQ)


def batches(vocab: int):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(STEPS):
        tok = rng.integers(0, vocab, (BATCH, SEQ + 1), dtype=np.int32)
        out.append({"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    return out


def f32_weights():
    rp = ref_tf.init_params(ref_smoke_config(ARCH), jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype == jnp.bfloat16 else np.asarray(a), rp)


def _dp_rank(rank, world, init, weights):
    torch.set_num_threads(1)
    mesh_lib.init_ranks("gloo", rank=rank, world_size=world,
                        init_method=init, device="cpu")
    mesh = mesh_lib.make_local_mesh(device="cpu")
    cfg = smoke_config(ARCH)
    params = params_from_jax(cfg, weights, device="cpu")
    out = {}
    for transport in step_lib.GRAD_TRANSPORTS:
        ef = transport == "int8_ef"
        state = opt.init_state(params, error_feedback=ef, ef_devices=1)
        fn = step_lib.make_train_step(cfg, opt.AdamWConfig(**ADAMW),
                                      grad_transport=transport, mesh=mesh)
        p, metrics, wire = params, [], []
        for nb in batches(cfg.vocab):
            coll.reset_wire_bytes()
            p, state, m = fn(p, state, {k: torch.from_numpy(v)
                                        for k, v in nb.items()})
            metrics.append({k: float(v) for k, v in m.items()})
            wire.append(coll.wire_bytes())
        out[transport] = {
            "metrics": metrics, "wire": wire,
            "params": [t.numpy() for t in tree_leaves(p)],
            "ef": [t.numpy() for t in tree_leaves(state["ef"])] if ef
            else None}
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dp") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", REFERENCE, ARCH, str(path)],
                          capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_dp_rank, W, f32_weights(), timeout=GROUP_S,
                     tmp_dir=str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("transport", step_lib.GRAD_TRANSPORTS)
def test_dp_step_matches_reference_data_parallel_step(reference, ranks,
                                                      transport):
    lr_sum = sum(float(ref_opt.lr_schedule(ref_opt.AdamWConfig(**ADAMW),
                                           jnp.int32(s + 1)))
                 for s in range(STEPS))
    for r, got in enumerate(ranks):
        arm = got[transport]
        for i, m in enumerate(arm["metrics"]):
            for k, v in m.items():
                want = float(reference[f"{transport}/m/{i}/{k}"])
                if k == "lr":
                    assert v == want, (r, i)
                    continue
                tol = (GNORM_TOL if k == "grad_norm" else LOSS_TOL)[transport]
                assert abs(v - want) <= tol * max(1.0, abs(want)), \
                    (transport, r, i, k, v, want)
        errs = np.concatenate([
            np.abs(p - reference[f"{transport}/p/{j}"]).reshape(-1)
            for j, p in enumerate(arm["params"])]) / lr_sum
        assert errs.max() <= PARAM_ALL[transport], errs.max()
        assert (errs > PARAM_MOST).mean() <= PARAM_FRAC[transport]
        # the parameters stay replicated: every rank holds the same
        for a, b in zip(arm["params"], ranks[0][transport]["params"]):
            assert np.array_equal(a, b)


def test_int8_ef_residual_is_per_rank(reference, ranks):
    far = []
    for r, got in enumerate(ranks):
        for j, e in enumerate(got["int8_ef"]["ef"]):
            want = reference[f"int8_ef/ef/{j}"]
            assert e.shape == (1,) + want.shape[1:] and want.shape[0] == W
            scale = max(float(np.abs(want[r]).max()), 1e-30)
            far.append((np.abs(e[0] - want[r]) > EF_MOST * scale).reshape(-1))
            assert np.abs(e).sum() > 0
    assert np.concatenate(far).mean() <= EF_FRAC
    # each rank's quantization error is its own
    assert not np.array_equal(ranks[0]["int8_ef"]["ef"][0],
                              ranks[1]["int8_ef"]["ef"][0])


def test_int8_ef_moves_fewer_counted_bytes_than_bf16(ranks):
    for got in ranks:
        bf16 = [sum(w.values()) for w in got["bf16"]["wire"]]
        int8 = [sum(w.values()) for w in got["int8_ef"]["wire"]]
        assert set(got["bf16"]["wire"][0]) == {"all_reduce"}
        assert set(got["int8_ef"]["wire"][0]) == {
            "all_to_all_single", "all_gather_into_tensor", "all_reduce"}
        assert all(i < b / 1.5 for i, b in zip(int8, bf16)), (int8, bf16)
