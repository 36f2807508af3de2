"""The port's sweep harness (core/autotune.py, kernels/tune.py) against the
JAX package's, on the CPU.

``tune_design`` is a copy with its imports retargeted, so its walk (the
history of points and objectives) equals the reference's for a fixed
objective. ``tune_op`` is driven in both packages with the same
deterministic stand-in for ``time_point``: both pick the same point after
the same number of evaluations, persist it, and serve the second call from
the cache with zero evaluations. Examples build on the card unless asked
for the CPU, and refuse without a card.
"""

import math

import pytest
import torch

from repro.core import autotune as jautotune
from repro.kernels import api as japi
from repro.kernels import tune as jtune
from repro.kernels import tuned as jtuned
from repro_torch.core import autotune
from repro_torch.kernels import api, tune, tuned

PORTED_OPS = ("compact_pack", "rmsnorm", "decode_attn", "paged_attn",
              "flash_attn", "expert_a2a")
# ops whose candidates equal the reference's (flash_attn's block_k takes
# the kv tiles the card's kernel is built for)
SAME_GRID_OPS = tuple(o for o in PORTED_OPS if o != "flash_attn")


def _objective(point):
    """A deterministic bowl over block sizes with its floor off-grid."""
    return sum((i + 1) * abs(math.log2(v) - 7.3)
               for i, v in enumerate(point.values()))


def _fake_time_point(op, point, args, kwargs, iters=3):
    return _objective(point)


@pytest.fixture()
def fake_sweep(tmp_path, monkeypatch):
    """Throwaway caches for both packages, the stand-in timer, and example
    operands built on the CPU."""
    monkeypatch.setenv("REPRO_TUNED_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("REPRO_TORCH_TUNED_DIR", str(tmp_path / "torch"))
    monkeypatch.setattr(jtune, "time_point", _fake_time_point)
    monkeypatch.setattr(tune, "time_point", _fake_time_point)
    monkeypatch.setattr(api, "example_device",
                        lambda op_name, device: torch.device("cpu"))
    jtuned.invalidate_memo()
    tuned.invalidate_memo()
    yield tmp_path
    jtuned.invalidate_memo()
    tuned.invalidate_memo()


AXES = {"a": (64, 128, 256, 512), "b": (32, 64, 128), "c": (1, 2, 4, 8, 16)}


@pytest.mark.parametrize("exhaustive", [True, False])
@pytest.mark.parametrize("start", [None, {"a": 512, "b": 32, "c": 16}])
def test_tune_design_history_matches_jax(exhaustive, start):
    got = autotune.tune_design(_objective, AXES, start=start,
                               exhaustive=exhaustive)
    want = jautotune.tune_design(_objective, AXES, start=start,
                                 exhaustive=exhaustive)
    assert got.history == want.history
    assert got.best_point == want.best_point
    assert (got.best_objective, got.evaluations, got.rounds) \
        == (want.best_objective, want.evaluations, want.rounds)


def test_tune_threshold_matches_jax():
    f = lambda x: (x - 0.37) ** 2                      # noqa: E731
    got = autotune.tune_threshold(f, 0.0, 1.0)
    want = jautotune.tune_threshold(f, 0.0, 1.0)
    assert got.history == want.history
    assert got.best_threshold == want.best_threshold


@pytest.mark.parametrize("name", SAME_GRID_OPS)
def test_tune_op_picks_the_jax_point_then_hits_the_cache(fake_sweep, name):
    got = tune.tune_op(name, quick=True)
    want = jtune.tune_op(name, quick=True)
    assert got.shape_key == want.shape_key
    assert got.point == want.point
    assert got.default == want.default
    assert got.evaluations == want.evaluations > 0
    assert [p for p, _ in got.history] == [p for p, _ in want.history]
    assert not got.cache_hit
    assert tuned.lookup(name, got.shape_key) == got.point
    again = tune.tune_op(name, quick=True)
    assert again.cache_hit and again.evaluations == 0
    assert again.point == got.point
    assert again.objective_us == pytest.approx(got.objective_us)
    forced = tune.tune_op(name, quick=True, force=True)
    assert not forced.cache_hit and forced.evaluations == got.evaluations


def test_flash_tune_op_picks_the_best_point_of_its_grid(fake_sweep):
    got = tune.tune_op("flash_attn", quick=True)
    grid = [{"block_q": q, "block_k": k} for q in (128, 256)
            for k in (32, 64, 128)]
    assert got.evaluations == len(grid)
    assert got.point == min(grid, key=_objective)
    assert tune.tune_op("flash_attn", quick=True).evaluations == 0


def test_tune_registry_writes_one_entry_per_op(fake_sweep):
    first = tune.tune_registry(quick=True)
    assert set(first) == set(PORTED_OPS)
    for name, out in first.items():
        rec = tuned.entry(name, out.shape_key)
        assert rec["device_kind"] == tuned.device_kind() == "cpu"
        assert rec["point"] == out.point
        assert rec["evaluations"] == out.evaluations > 0
    second = tune.tune_registry(quick=True)
    assert all(o.cache_hit and o.evaluations == 0 for o in second.values())
    assert {n: o.point for n, o in second.items()} \
        == {n: o.point for n, o in first.items()}


def test_time_point_times_the_plain_version_on_cpu():
    op = api.get_op("rmsnorm")
    args, kwargs = op.example(True, device="cpu")
    us = tune.time_point(op, {"block_rows": 256}, args, kwargs, iters=1)
    assert us > 0


@pytest.mark.parametrize("name", PORTED_OPS)
def test_example_builds_on_the_card_or_refuses(name, monkeypatch):
    op = api.get_op(name)
    args, _ = op.example(True, device="cpu")
    assert all(a.device.type == "cpu" for a in args
               if isinstance(a, torch.Tensor))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        op.example(True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.tune_op(name, force=True)


@pytest.mark.parametrize("name", PORTED_OPS)
def test_example_cells_match_jax(name):
    op, jop = api.get_op(name), japi.get_op(name)
    for quick in (True, False):
        args, kwargs = op.example(quick, device="cpu")
        jargs, jkwargs = jop.example(quick)
        assert op.shape_key(*args, **kwargs) \
            == jop.shape_key(*jargs, **jkwargs)
        assert api.clamped_axes(op, *args, **kwargs).keys() \
            == japi.clamped_axes(jop, *jargs, **jkwargs).keys()
