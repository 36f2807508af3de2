"""The port's Trainer and training launcher against the JAX package's, on
the CPU.

* A Trainer over the same numpy batches as the reference's, on the same
  f32 weights (the reference's ``init_params``, carried across), with
  checkpoints every 5 steps: the loss history within 2e-6 x max(1, |loss|)
  at every step (measured under 4e-7).
* Preemption: the run restores the last checkpoint and resumes at its
  step, as the reference's does; without a checkpoint it restarts from 0.
* Stragglers: with the step times made deterministic through the hook,
  the detected steps equal the reference's.
* The launcher's ``build_data`` / ``build_autocomp`` cycles merged with
  ``device="cpu"``: the same reports, file counts and store bytes as the
  reference's.
* ``main([... "--device", "cpu"])`` runs, its loss falls and it prints an
  ``[autocomp]`` line.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as RefModelConfig
from repro.configs import smoke_config as ref_smoke_config
from repro.launch import train as ref_launch
from repro.lst import InMemoryStore as RefStore
from repro.models import transformer as ref_tf
from repro.train import optimizer as ref_opt
from repro.train import runner as ref_runner
from repro.train import step as ref_step
from repro.train.checkpoints import CheckpointManager as RefCkpt
from repro_torch.configs import ModelConfig, smoke_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as launch
from repro_torch.lst import InMemoryStore
from repro_torch.models import params_from_jax
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_lib
from repro_torch.train.checkpoints import CheckpointManager
from repro_torch.train.runner import (RunnerConfig, SimulatedPreemption,
                                      Trainer)

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=128, head_dim=8,
            tie_embeddings=True)
LOSS_TOL = 2e-6


def setup(steps: int):
    """Both packages' (step_fn, params, opt_state, batches) on the same
    f32 weights and numpy batches, as ``tests/test_train_runner.py``
    builds them."""
    rcfg, cfg = RefModelConfig(**TINY), ModelConfig(**TINY)
    rp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      ref_tf.init_params(rcfg, jax.random.PRNGKey(0)))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, rp), device="cpu")
    adamw = {"lr": 1e-3, "warmup_steps": 2, "total_steps": steps}
    rstep = jax.jit(ref_step.make_train_step(
        rcfg, ref_opt.AdamWConfig(**adamw)))
    tstep = step_lib.make_train_step(cfg, opt.AdamWConfig(**adamw))
    data = np.random.RandomState(0).randint(
        0, cfg.vocab, size=(64, 4, 33)).astype(np.int32)

    def rbatches():
        for slab in data:
            yield {"tokens": slab[:, :-1], "labels": slab[:, 1:]}

    def tbatches():
        for slab in data:
            yield {"tokens": torch.from_numpy(slab[:, :-1]),
                   "labels": torch.from_numpy(slab[:, 1:])}

    return ((rstep, rp, ref_opt.init_state(rp), rbatches),
            (tstep, tp, opt.init_state(tp), tbatches))


def preempt_at(step_no: int, exc=SimulatedPreemption):
    fired = {"done": False}

    def fault(step):
        if step == step_no and not fired["done"]:
            fired["done"] = True
            raise exc()
    return fault


def test_loss_history_matches_reference_with_checkpoints():
    (rstep, rp, ro, rb), (tstep, tp, to, tb) = setup(12)
    cfg = RunnerConfig(total_steps=12, ckpt_every=5)
    rtr = ref_runner.Trainer(ref_runner.RunnerConfig(total_steps=12,
                                                     ckpt_every=5),
                             rstep, rp, ro, rb, ckpt=RefCkpt(RefStore()))
    ttr = Trainer(cfg, tstep, tp, to, tb, ckpt=CheckpointManager(InMemoryStore()))
    rout, tout = rtr.run(), ttr.run()
    assert tout["final_step"] == rout["final_step"] == 12
    assert [h["step"] for h in tout["history"]] == list(range(12))
    for r, t in zip(rout["history"], tout["history"]):
        assert abs(t["loss"] - r["loss"]) <= LOSS_TOL * max(1, abs(r["loss"])), \
            (r["step"], t["loss"], r["loss"])
    assert tout["history"][-1]["loss"] < tout["history"][0]["loss"]
    assert ttr.ckpt.available_steps() == rtr.ckpt.available_steps()


def test_preemption_resumes_at_the_checkpointed_step():
    (rstep, rp, ro, rb), (tstep, tp, to, tb) = setup(25)
    rtr = ref_runner.Trainer(
        ref_runner.RunnerConfig(total_steps=25, ckpt_every=5), rstep, rp, ro,
        rb, ckpt=RefCkpt(RefStore(), keep_last=3),
        fault_hook=preempt_at(17, ref_runner.SimulatedPreemption))
    ttr = Trainer(RunnerConfig(total_steps=25, ckpt_every=5), tstep, tp, to,
                  tb, ckpt=CheckpointManager(InMemoryStore(), keep_last=3),
                  fault_hook=preempt_at(17))
    rout, tout = rtr.run_with_recovery(), ttr.run_with_recovery()
    assert ttr.restarts == rtr.restarts == 1
    assert tout["final_step"] == 25
    steps = [h["step"] for h in tout["history"]]
    assert steps == [h["step"] for h in rout["history"]]
    # resumed at step 15 (the last checkpoint), not at 0
    assert steps == list(range(17)) + list(range(15, 25))
    assert int(ttr.opt_state["step"]) == 25


def test_recovery_without_checkpoint_restarts_from_zero():
    _, (tstep, tp, to, tb) = setup(6)
    tr = Trainer(RunnerConfig(total_steps=6, ckpt_every=100), tstep, tp, to,
                 tb, ckpt=None, fault_hook=preempt_at(3))
    out = tr.run_with_recovery()
    assert out["final_step"] == 6 and tr.restarts == 1
    assert [h["step"] for h in out["history"]] == [0, 1, 2, 3, 4, 5]


def test_stragglers_match_reference():
    (rstep, rp, ro, rb), (tstep, tp, to, tb) = setup(24)

    def inject(step, dt):
        # the step's time made deterministic: 0.01 s, 0.5 s at 10 and 20
        return (0.5 if step in (10, 20) else 0.01) - dt

    seen = {"ref": [], "port": []}
    kw = dict(total_steps=24, straggler_window=8, straggler_factor=3.0)
    rtr = ref_runner.Trainer(
        ref_runner.RunnerConfig(**kw), rstep, rp, ro, rb,
        straggler_hook=inject,
        on_straggler=lambda s, dt, med: seen["ref"].append(s))
    ttr = Trainer(RunnerConfig(**kw), tstep, tp, to, tb,
                  straggler_hook=inject,
                  on_straggler=lambda s, dt, med: seen["port"].append(s))
    rtr.run()
    ttr.run()
    assert ttr.stragglers_detected == rtr.stragglers_detected == [10, 20]
    assert seen["port"] == seen["ref"] == [10, 20]


@pytest.mark.parametrize("compact_every", [5, 25])
def test_launcher_cycles_match_reference(compact_every):
    """The launcher's data and AutoComp wiring, ticked as ``main`` ticks
    it for 60 steps, merged on the host."""
    arch = "paper-lm-100m"
    rcat, rtable, _, rclock, rstore = ref_launch.build_data(
        ref_smoke_config(arch), batch=4, seq_len=128)
    cat, table, pipe, clock, store = launch.build_data(
        smoke_config(arch), batch=4, seq_len=128, device="cpu")
    rauto = ref_launch.build_autocomp(rcat, rclock)
    auto = launch.build_autocomp(cat, clock, device="cpu")
    cycles = 0
    for i in range(1, 61):
        rclock.advance(0.01)
        clock.advance(0.01)
        if i % compact_every == 0:
            rr, r = rauto.run_cycle(rcat), auto.run_cycle(cat)
            cycles += 1
            assert (r.files_removed, r.gbhr) == (rr.files_removed, rr.gbhr)
            assert table.file_count() == rtable.file_count()
    assert cycles == 60 // compact_every
    assert rtable.file_count() < 450
    paths = rstore.list("")
    assert store.list("") == paths
    assert all(store.get(p) == rstore.get(p) for p in paths)
    assert pipe.device == torch.device("cpu")


def test_main_on_the_cpu(capsys):
    out = launch.main(["--smoke", "--steps", "30", "--batch", "4",
                       "--seq-len", "128", "--device", "cpu"])
    text = capsys.readouterr().out
    losses = [h["loss"] for h in out["history"]]
    assert out["final_step"] == 30 and losses[-1] < losses[0]
    assert "[autocomp] cycle: removed" in text
    assert "[train] arch=paper-lm-100m-smoke" in text
    assert "mesh={'data': 1, 'model': 1}" in text
    assert out["launch"].table.file_count() < 450
    assert out["launch"].trainer.ckpt.available_steps() == [20, 30]


def test_entry_points_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.make_local_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--smoke", "--steps", "2"])
    with pytest.raises(ValueError, match="a world of 256 ranks"):
        mesh_lib.make_production_mesh()
