"""The SPMD train step, sharded checkpoints and the launcher across ranks.

One 2 x 2 gloo group on the CPU (``(data 2, model 2)`` under
``baseline``) holds:
  * the SPMD step on smoke ``paper-lm-100m`` in f32 against the one-device
    step, 3 steps of the same 8 x 16 global batches in 2 microbatches:
    every metric within 2e-6 relative (measured 7.1e-7; the last
    microbatch's ``ce_loss`` and ``grad_norm`` read the same rows as on
    one device) and every parameter within 2e-5 of the one-device step's
    (measured 4.6e-6; the sharded contractions sum in another order);
  * the same under ``int8_ef`` against the one-device ``int8_ef`` step,
    but a gradient summed in another order can round to the next int8
    step, which AdamW then follows for one step: every parameter within
    one step's ``lr`` and at most 1e-4 of them beyond 2e-5 (measured:
    3.4e-5 on 2 of 90432);
  * one step of every other family's smoke config, both transports,
    against the one-device step: metrics as above, parameters within
    5e-5 (measured 1.5e-5, MiniCPM3's latent projections summed over
    sharded ranks) or, under ``int8_ef``, as above (measured 5e-4 = the
    step's ``lr`` on 1 of 172352, InternVL2);
  * each leaf's local shard the shape ``resolve_spec`` gives;
  * a save of the sharded parameters and moments: the same object bytes
    and manifest as a one-device save of the same values, written once;
  * ``restore(shardings=...)`` onto the same mesh (placements and values
    back bit for bit) and onto a ``(4, 1)`` mesh (the elastic restore);
    with no checkpoint every rank raises ``FileNotFoundError``.
A 4-rank group runs the launcher (smoke, 6 steps of 8 x 64, a cycle
every 3) and holds its losses to the one-process launcher's within 5e-4
relative (bf16 weights; measured 5e-5), with one ``[autocomp]`` line.
"""

from __future__ import annotations

import contextlib
import io

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.configs.shapes import ShapeSpec, make_batch
from repro_torch.dist import sharding as shd
from repro_torch.dist.spawn import run_ranks
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as launch
from repro_torch.lst import InMemoryStore
from repro_torch.models import transformer as tf
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_lib
from repro_torch.train.checkpoints import CheckpointManager

ARCH = "paper-lm-100m"
FAMILIES = ("qwen3-moe-30b-a3b", "minicpm3-4b", "hymba-1.5b",
            "hubert-xlarge", "internvl2-2b", "xlstm-125m")
ADAMW = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 30}
STEPS, BATCH, SEQ, MICRO = 3, 8, 16, 2
METRIC_TOL = 2e-6
PARAM_TOL, FAMILY_PARAM_TOL, FLIP_FRAC = 2e-5, 5e-5, 1e-4
LAUNCH_ARGV = ["--smoke", "--steps", "6", "--batch", "8", "--seq-len", "64",
               "--compact-every", "3", "--device", "cpu"]
LAUNCH_TOL = 5e-4
GROUP_S = 420


def batches(cfg, steps: int = STEPS):
    """``steps`` global batches of ``cfg``'s train inputs, f32 floats."""
    gen = torch.Generator().manual_seed(1)
    for _ in range(steps):
        nb, _ = make_batch(cfg, ShapeSpec("t", "train", SEQ, BATCH), gen,
                           device="cpu")
        yield {k: v.float() if v.is_floating_point() else v
               for k, v in nb.items()}


def f32_params(cfg):
    return tree_map(lambda p: p.float(),
                    tf.init_params(cfg, seed=0, device="cpu"))


def run_steps(step_fn, params, state, cfg, steps: int = STEPS):
    """The final parameters and state, and each step's metrics."""
    metrics = []
    for nb in batches(cfg, steps):
        params, state, m = step_fn(params, state, nb)
        metrics.append({k: float(v) for k, v in m.items()})
    return params, state, metrics


def run_arm(cfg, transport: str, params, steps: int = STEPS):
    """``steps`` steps in ``MICRO`` microbatches from ``params``: each
    step's metrics and the final parameters, as numpy."""
    step_fn = step_lib.make_train_step(cfg, opt.AdamWConfig(**ADAMW),
                                       microbatches=MICRO,
                                       grad_transport=transport)
    state = opt.init_state(params, error_feedback=transport == "int8_ef")
    params, _, metrics = run_steps(step_fn, params, state, cfg, steps)
    return metrics, [(p.full_tensor() if shd.is_dtensor(p) else p).numpy()
                     for p in tree_leaves(params)]


def assert_same_run(got, want, transport: str, tol: float = PARAM_TOL):
    (g_metrics, g_params), (w_metrics, w_params) = got, want
    for g, w in zip(g_metrics, w_metrics, strict=True):
        assert g.keys() == w.keys()
        for k in w:
            assert abs(g[k] - w[k]) <= METRIC_TOL * abs(w[k]), (k, g[k], w[k])
    err = np.concatenate([np.abs(a - b).ravel()
                          for a, b in zip(g_params, w_params)])
    if transport == "bf16":
        assert err.max() <= tol, err.max()
    else:           # a few int8 steps apart, each one AdamW step at most
        assert err.max() <= ADAMW["lr"], err.max()
        assert (err > PARAM_TOL).mean() <= FLIP_FRAC, (err > PARAM_TOL).sum()


def store_bytes(store) -> dict:
    return {p: store.get(p) for p in store.list("")}


def _grads_on_another_thread(cfg, params, mesh, rules) -> bool:
    """A CUDA backward runs on the autograd engine's device thread, where
    the forward's ``axis_rules`` context is not: the recomputed units must
    lay out as in the forward all the same. Here the backward runs on
    another thread on the host, and its gradients equal a backward on the
    forward's thread."""
    import threading

    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    rows = BATCH // mesh.size(0)
    start = mesh.get_local_rank("data") * rows
    batch = {k: DTensor.from_local(v[start:start + rows], mesh, list(
        shd.placements(("data",), mesh))) for k, v in
        next(batches(cfg)).items()}

    def loss():
        return tf.forward(cfg, tree_unflatten(params, leaves), batch,
                          "train")[0]

    def backward(pending, box):
        # the engine carries DTensor's own thread state to its device
        # thread, not this module's context stack
        with implicit_replication():
            box.append(torch.autograd.grad(pending, leaves))

    with shd.axis_rules(mesh, rules):
        here = torch.autograd.grad(loss(), leaves)
        box = []
        t = threading.Thread(target=backward, args=(loss(), box))
        t.start()
        t.join(timeout=60)
    return bool(box) and all(torch.equal(a.full_tensor(), b.full_tensor())
                             for a, b in zip(here, box[0]))


def _spmd_rank(rank, world, init):
    torch.set_num_threads(1)
    mesh_lib.init_ranks("gloo", rank=rank, world_size=world,
                        init_method=init, device="cpu")
    mesh = mesh_lib.make_local_mesh(2, device="cpu")
    rules = shd.PRESETS["baseline"]
    cfg = smoke_config(ARCH)
    axes = tf.param_axes(cfg)
    params = shd.distribute_tree(f32_params(cfg), axes, mesh, rules)
    out = {"shapes": [
        (tuple(p.to_local().shape),
         shd.local_shape(p.shape, shd.resolve_spec(p.shape, a, mesh, rules),
                         mesh))
        for p, a in zip(tree_leaves(params), tree_leaves(axes, tf.is_axes))]}
    with shd.axis_rules(mesh, rules):
        step_fn = step_lib.make_train_step(cfg, opt.AdamWConfig(**ADAMW),
                                           microbatches=MICRO)
    start = params
    params, state, metrics = run_steps(step_fn, params,
                                       opt.init_state(params), cfg)
    out["bf16"] = (metrics, [p.full_tensor().numpy()
                             for p in tree_leaves(params)])
    with shd.axis_rules(mesh, rules):
        out["int8_ef"] = run_arm(cfg, "int8_ef", start)
    for arch in FAMILIES:
        fcfg = smoke_config(arch)
        placed = shd.distribute_tree(f32_params(fcfg), tf.param_axes(fcfg),
                                     mesh, rules)
        with shd.axis_rules(mesh, rules):
            for transport in step_lib.GRAD_TRANSPORTS:
                out[arch, transport] = run_arm(fcfg, transport, placed, 1)
    out["other_thread"] = _grads_on_another_thread(cfg, params, mesh, rules)
    # a sharded save: every rank gathers, rank 0 writes
    store = InMemoryStore()
    tree = (params, {"mu": state["mu"], "nu": state["nu"]}, STEPS)
    CheckpointManager(store).save(STEPS, tree)
    out["saved"] = store_bytes(store)
    full = tree_map(lambda t: t.full_tensor() if shd.is_dtensor(t) else t,
                    tree)
    one = InMemoryStore()
    if rank == 0:
        CheckpointManager(one).save(STEPS, full)
    out["one_device"] = store_bytes(one)
    # restore onto this mesh, and onto a (4, 1) mesh of the same ranks
    mgr = CheckpointManager(store)
    sh = (shd.tree_shardings(params, axes, mesh, rules),
          {"mu": shd.tree_shardings(state["mu"], axes, mesh, rules),
           "nu": shd.tree_shardings(state["nu"], axes, mesh, rules)},
          None)
    (p2, m2, s2), step = mgr.restore(tree, shardings=sh)
    out["restored"] = (step, int(s2), all(
        tuple(a.placements) == tuple(b.placements)
        and torch.equal(a.full_tensor(), b.full_tensor())
        for a, b in zip(tree_leaves((p2, m2)), tree_leaves(tree[:2]))))
    # rank 0 finds no checkpoint: every rank raises, none waits
    try:
        CheckpointManager(InMemoryStore()).restore(tree, shardings=sh)
        out["empty"] = "restored"
    except FileNotFoundError:
        out["empty"] = "missing"
    wide = mesh_lib.make_local_mesh(1, device="cpu")
    sh4 = (shd.tree_shardings(params, axes, wide, rules),
           {"mu": shd.tree_shardings(state["mu"], axes, wide, rules),
            "nu": shd.tree_shardings(state["nu"], axes, wide, rules)},
           None)
    (p4, m4, _), _ = mgr.restore(tree, shardings=sh4)
    out["elastic"] = (
        tuple(p4["embed"].placements),
        all(a.device_mesh is wide and torch.equal(a.full_tensor(),
                                                  b.full_tensor())
            for a, b in zip(tree_leaves((p4, m4)), tree_leaves(tree[:2]))))
    return out


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    return run_ranks(_spmd_rank, 4, timeout=GROUP_S,
                     tmp_dir=str(tmp_path_factory.mktemp("spmd")))


def test_spmd_step_matches_the_one_device_step(spmd):
    want = run_arm(smoke_config(ARCH), "bf16", f32_params(smoke_config(ARCH)))
    for got in spmd:
        assert_same_run(got["bf16"], want, "bf16")


def test_spmd_int8_ef_step_matches_the_one_device_step(spmd):
    cfg = smoke_config(ARCH)
    want = run_arm(cfg, "int8_ef", f32_params(cfg))
    for got in spmd:
        assert_same_run(got["int8_ef"], want, "int8_ef")


@pytest.mark.parametrize("arch", FAMILIES)
def test_spmd_step_runs_every_family(spmd, arch):
    cfg = smoke_config(arch)
    for transport in step_lib.GRAD_TRANSPORTS:
        want = run_arm(cfg, transport, f32_params(cfg), 1)
        for got in spmd:
            assert_same_run(got[arch, transport], want, transport,
                            FAMILY_PARAM_TOL)


def test_recompute_on_another_thread_keeps_the_layout(spmd):
    assert all(got["other_thread"] for got in spmd)


def test_local_shards_have_resolve_spec_shapes(spmd):
    for got in spmd:
        assert all(a == b for a, b in got["shapes"]), got["shapes"]
    assert any(a != tuple(s.shape) for (a, _), s in zip(
        spmd[0]["shapes"], tree_leaves(tf.abstract_params(
            smoke_config(ARCH)), tf.is_tensor_spec)))


def test_sharded_save_writes_the_one_device_bytes_once(spmd):
    saved, one = spmd[0]["saved"], spmd[0]["one_device"]
    assert saved and saved == one
    assert any(p.endswith("MANIFEST.json") for p in saved)
    assert all(not got["saved"] for got in spmd[1:])


def test_restore_with_shardings_round_trips(spmd):
    from torch.distributed.tensor import Replicate, Shard

    for got in spmd:
        assert got["restored"] == (STEPS, STEPS, True)
        assert got["empty"] == "missing"
        # (vocab, embed) on (data 4, model 1): embed over data; a model
        # axis of one splits nothing, so vocab is replicated over it
        assert got["elastic"] == ((Shard(1), Replicate()), True)


def _launch_rank(rank, world, init):
    torch.set_num_threads(1)
    mesh_lib.init_ranks("gloo", rank=rank, world_size=world,
                        init_method=init, device="cpu")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = launch.main(LAUNCH_ARGV)
    run = out["launch"]
    return {"text": text.getvalue(),
            "losses": [h["loss"] for h in out["history"]],
            "steps": run.trainer.ckpt.available_steps(),
            "embed": tuple(run.trainer.params["embed"].placements)}


def test_the_launcher_across_four_ranks(tmp_path):
    from torch.distributed.tensor import Replicate, Shard

    res = run_ranks(_launch_rank, 4, timeout=GROUP_S, tmp_dir=str(tmp_path))
    with contextlib.redirect_stdout(io.StringIO()):
        one = launch.main(LAUNCH_ARGV)
    want = [h["loss"] for h in one["history"]]
    text = res[0]["text"]
    assert text.count("[autocomp] cycle") == 1, text
    assert "mesh={'data': 4, 'model': 1}" in text
    assert not any(r["text"] for r in res[1:])
    assert res[0]["steps"] == [6] and not any(r["steps"] for r in res[1:])
    for r in res:
        assert r["losses"] == res[0]["losses"]
        assert r["embed"] == (Shard(1), Replicate())
    for a, b in zip(res[0]["losses"], want):
        assert abs(a - b) <= LAUNCH_TOL * abs(b), (a, b)
    assert res[0]["losses"][-1] < res[0]["losses"][0]
