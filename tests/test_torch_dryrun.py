"""The port's dry run against the JAX package's.

``repro_torch.launch.dryrun`` runs each cell's step on fake tensors in a
fake process group. Here:
  * every arch x shape x mesh x preset: ``status``, ``skip_reason``,
    ``params``, ``active_params`` and ``model_flops`` equal the
    reference's, and the refusals behind ``skipped_families`` (slot
    streaming, the storage arms, the paged table) are the reference's
    checks' own;
  * on a fake (2, 2) mesh (a fake group of 4), smoke configs:
    - the decode step under ``serve_decode`` traces (no ``nonzero``);
    - a decode cell's record: ``collectives``, ``roofline`` with the H100
      constants, ``disagg`` and ``fanin``, the int8 act-gather wire below
      bf16's over 1.5 under ``serve_sp``; the ``disagg`` block's resident
      bytes and every wire byte count (transfer, decode step, slot stream)
      equal the reference's report on 4 forced host devices (a JAX
      subprocess), the ``fanin`` block equal to the reference's on the
      same inputs, and the relations of
      ``tests/test_serve_disagg.py::TestDisaggDryrunReport``;
    - the ``int8_ef`` train cell gathers no leaf (every shard holds whole
      blocks at these widths) and its modeled gradient wire is bf16's
      times ``INT8_EF_WIRE_RATIO``;
  * two full-size (16, 16) ``--lower-only`` cells (``paper-lm-100m`` and
    ``granite-3-8b`` ``prefill_8k``) through ``main``: their ``dot_flops``
    and ``hbm_bytes`` equal the reference's ``--lower-only`` records (a
    JAX subprocess).
Each test leaves no process group behind.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as ref_get_config
from repro.configs import shapes as ref_shapes
from repro.launch import analysis as ref_analysis
from repro.launch import serve as ref_serve
from repro.models import registry as ref_registry
from repro.train import step as ref_step
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.configs import shapes
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun, serve
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import registry
from repro_torch.train import step as step_lib

REPORT = dict(batch=8, seq_len=512, blocks=(256, 128))
STORAGES = ("bf16", "int8", "f8")
# the full-size --lower-only cells: Granite's 8 KV heads replicate up to
# the 16-wide model axis under the mesh's rules, paper-lm-100m's do not
FULL_SIZE = ("paper-lm-100m", "granite-3-8b")
SUBPROCESS_S = 240

REFERENCE_REPORT = """
import json, sys
import jax
import numpy as np
from repro.configs import smoke_config
from repro.launch import serve
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                         ("data", "model"))
rep = serve.disagg_decode_report(smoke_config(sys.argv[1]), 8, 512, mesh,
                                 blocks=(256, 128))
print(json.dumps(rep, default=str))
"""


def _env(devices: int = 4) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(p) for p in sys.path if p] + [env.get("PYTHONPATH", "")])
    return env


@pytest.fixture(scope="module")
def reference_report():
    """The reference's disagg report on its (2, 2) mesh, from a JAX
    subprocess started before the port's work and read after it."""
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_REPORT, "paper-lm-100m"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env())
    yield proc
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def reference_lowered(tmp_path_factory):
    """The reference's ``--lower-only`` records of ``FULL_SIZE``'s
    prefill_8k on its 16 x 16 mesh, from a JAX subprocess."""
    out = tmp_path_factory.mktemp("ref_dryrun")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch",
         ",".join(FULL_SIZE), "--shape", "prefill_8k", "--mesh", "pod",
         "--lower-only", "--out", str(out), "--force"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(512))
    yield proc, out
    if proc.poll() is None:
        proc.kill()


@pytest.fixture
def mesh22():
    """A fake group of 4 and its (2, 2) mesh; the group is destroyed and
    the dry run's memos cleared after the test."""
    dryrun.fake_world(4)
    try:
        yield make_local_mesh(2, device="cpu")
    finally:
        dryrun.leave_fake_world()
        dryrun._SERVE_COLL_MEMO.clear()
        dryrun._DISAGG_MEMO.clear()
    assert not dist.is_initialized()


def _refusals(serve_mod, step_mod, registry_mod, cfg, storages=("bf16",
                                                                 "int8")):
    """The ``skipped_families`` a decode record lists: the disagg
    report's refusals (slot streaming, each storage arm) sorted, then the
    fan-in report's (the paged table)."""
    rep, frep = {}, {}
    try:
        serve_mod._require_slot_streaming(cfg)
    except NotImplementedError as e:
        rep["--stream slots"] = str(e)
    for s in storages:
        try:
            step_mod.make_decode_step(cfg, 512, "bf16", s)
        except NotImplementedError as e:
            rep[f"kv_storage={s!r}"] = str(e)
    try:
        registry_mod.require(cfg, "paged", "--paged")
    except NotImplementedError as e:
        frep["--paged"] = str(e)
    return [{"family": cfg.family, "flag": f, "reason": r}
            for part in (rep, frep) for f, r in sorted(part.items())]


# ---------------------------------------------------------------------------
# every cell: the checks that need no mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS + ("paper-lm-100m",))
def test_every_cells_checks_are_the_references(arch):
    ref_cfg = ref_get_config(arch)
    for name in shapes.SHAPE_IDS:
        for multi_pod in (False, True):
            for preset in sorted(shd.PRESETS):
                shape = shapes.SHAPES[name]
                ok, why = ref_shapes.applicable(ref_cfg,
                                                ref_shapes.SHAPES[name])
                if ok:
                    cfg = get_config(arch)
                    assert shapes.applicable(cfg, shape) == (ok, why)
                    assert cfg.param_count() == ref_cfg.param_count()
                    assert cfg.active_param_count() == \
                        ref_cfg.active_param_count()
                    assert dryrun.model_flops(cfg, shape) == \
                        ref_analysis.model_flops(ref_cfg,
                                                 ref_shapes.SHAPES[name])
                    continue
                rec = dryrun.lower_cell(arch, name, multi_pod,
                                        preset=preset, device="cpu")
                assert rec["status"] == "skip"
                assert rec["skip_reason"] == why
                assert rec["params"] == ref_cfg.param_count()
                assert rec["active_params"] == ref_cfg.active_param_count()
                assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
                assert not dist.is_initialized()     # the skip builds none
    if ref_cfg.causal:
        assert _refusals(serve, step_lib, registry,
                         get_config(arch)) == \
            _refusals(ref_serve, ref_step, ref_registry, ref_cfg)


# ---------------------------------------------------------------------------
# the fake (2, 2) mesh
# ---------------------------------------------------------------------------

def test_decode_traces_under_serve_decode(mesh22):
    """``_ring_update_shards`` writes every row, so fake tensors trace the
    decode step on a sharded cache."""
    cfg = smoke_config("granite-3-8b")
    shape = shapes.ShapeSpec("decode_smoke", "decode", 512, 8)
    walked = dryrun.collective_walk(cfg, shape, mesh22,
                                    shd.PRESETS["serve_decode"])
    assert walked["ops"]["total_wire_bytes"] > 0


def test_decode_cell_on_a_fake_mesh(mesh22, reference_report):
    cfg = smoke_config("paper-lm-100m")
    shape = shapes.ShapeSpec("decode_smoke", "decode", REPORT["seq_len"],
                             REPORT["batch"])
    shapes.SHAPES["decode_smoke"] = shape
    try:
        recs = {t: dryrun.lower_cell(
            "paper-lm-100m", "decode_smoke", False, preset="serve_sp",
            act_transport=t, stream_blocks=REPORT["blocks"],
            kv_storages=STORAGES, device="cpu", config=cfg, mesh=mesh22)
            for t in ("bf16", "int8")}
    finally:
        del shapes.SHAPES["decode_smoke"]
    for t, rec in recs.items():
        assert rec["status"] == "ok" and rec["chips"] == 4
        assert rec["act_transport"] == t
        assert set(rec["collectives"]) == set(ref_analysis.COLLECTIVE_OPS) \
            | {"total_" + k for k in ("bytes", "bytes_bf16eq", "wire_bytes",
                                      "wire_bytes_bf16eq",
                                      "wire_bytes_bf16eq_s8")}
        r = rec["roofline"]
        assert r["compute_s"] == pytest.approx(
            rec["jaxpr_cost"]["flops"] / 4 / 989e12)
        assert r["memory_s"] == pytest.approx(
            rec["jaxpr_cost"]["hbm_bytes"] / 4 / 3.35e12)
        assert r["collective_s"] == pytest.approx(
            rec["collectives"]["total_wire_bytes_bf16eq"] / 450e9)
        assert rec["skipped_families"] == _refusals(serve, step_lib,
                                                    registry, cfg, STORAGES)
        assert "disagg" in rec and "fanin" in rec
    act = recs["bf16"]["act_gather_wire_bytes_bf16eq"]
    assert recs["int8"]["act_gather_wire_bytes_bf16eq"] == act
    assert 0 < act["int8"] < act["bf16"] / 1.5
    assert recs["bf16"]["act_gather_wire_bytes_bf16eq_s8"] > 0

    # the disagg block against the reference's report
    out, err = reference_report.communicate(timeout=SUBPROCESS_S)
    assert reference_report.returncode == 0, err[-2000:]
    want = json.loads(out.strip().splitlines()[-1])
    got = recs["bf16"]["disagg"]
    assert set(got) - {"trace_s"} == set(want)
    assert set(got["cells"]) == set(want["cells"])
    for name, cell in got["cells"].items():
        assert set(cell) == set(want["cells"][name])
        assert cell["cache_resident_bytes_per_device"] == \
            want["cells"][name]["cache_resident_bytes_per_device"]
    assert got["hide_steps"] == want["hide_steps"]
    assert got["unsupported_storage"] == want["unsupported_storage"]
    assert got["skipped"] == want["skipped"]
    # every collective priced by the ring model: the transfer, its s8
    # part, the decode step's wire (DTensor's own redistributions
    # included) and each slot stream's, as the reference's compiled HLO
    for name, cell in got["cells"].items():
        for k in ("transfer_wire_bytes_bf16eq",
                  "transfer_wire_bytes_bf16eq_s8",
                  "decode_wire_bytes_bf16eq"):
            assert cell[k] == want["cells"][name][k], (name, k)
    for t, ss in got["slot_stream"].items():
        for k in ("wire_bytes_bf16eq", "wire_bytes_bf16eq_s8", "hide_steps"):
            assert ss[k] == want["slot_stream"][t][k], (t, k)
    # the fan-in block: the reference's on the same inputs
    cell0 = next(iter(got["cells"].values()))
    ss0 = next(iter(got["slot_stream"].values()))
    from repro.configs import smoke_config as ref_smoke_config
    frep = ref_serve.fanin_report(
        ref_smoke_config("paper-lm-100m"), REPORT["batch"],
        REPORT["seq_len"], decode_step_s=cell0["decode_step_s"],
        transfer_s=ss0["transfer_s"])
    assert recs["bf16"]["fanin"] == json.loads(json.dumps(frep))


def test_disagg_block_relations(mesh22):
    """``TestDisaggDryrunReport``'s assertions on the dry run's block."""
    cfg = smoke_config("paper-lm-100m")
    shape = shapes.ShapeSpec("decode_smoke", "decode", 512, 8)
    rep = dryrun._disagg(cfg, shape, mesh22, "cpu", ("bf16", "int8"),
                         STORAGES, (256, 128))
    cells = rep["cells"]
    assert set(cells) == {f"{t}x{s}" for t in ("bf16", "int8")
                          for s in ("bf16", "int8", "f8")}
    for cell in cells.values():
        assert cell["collective_s"] >= 0
        assert cell["cache_resident_bytes_per_device"] > 0
        assert 0.0 <= cell["slot_stream_overlap_frac"] <= 1.0
    bf16 = cells["bf16xbf16"]["cache_resident_bytes_per_device"]
    assert cells["bf16xint8"]["cache_resident_bytes_per_device"] < bf16
    assert cells["bf16xf8"]["cache_resident_bytes_per_device"] == bf16 // 2
    assert cells["int8xbf16"]["transfer_wire_bytes_bf16eq"] \
        <= cells["bf16xbf16"]["transfer_wire_bytes_bf16eq"] / 1.5
    assert cells["int8xbf16"]["transfer_wire_bytes_bf16eq_s8"] > 0
    ss = rep["slot_stream"]
    for t in ("bf16", "int8"):
        assert 0 < ss[t]["wire_bytes_bf16eq"] \
            <= cells[f"{t}xbf16"]["transfer_wire_bytes_bf16eq"] / 2
    assert ss["int8"]["wire_bytes_bf16eq_s8"] \
        > ss["int8"]["wire_bytes_bf16eq"] / 2
    assert ss["int8"]["wire_bytes_bf16eq"] \
        <= ss["bf16"]["wire_bytes_bf16eq"] / 1.5
    sweep = rep["block_sweep"]["int8"]
    assert set(sweep) == {128, 256}
    assert sweep[128]["transfer_wire_bytes_bf16eq"] \
        >= sweep[256]["transfer_wire_bytes_bf16eq"]
    tuned = rep["tuned"]
    assert tuned["point"]["cache_transfer"] in ("bf16", "int8")
    assert tuned["point"]["kv_storage"] in ("bf16", "int8", "f8")
    assert tuned["point"]["block"] in (128, 256)
    assert tuned["collective_s"] > 0 and tuned["evaluations"] >= 1
    # the decode step's wire now counts DTensor's own redistributions
    assert cells["bf16xbf16"]["decode_wire_bytes_bf16eq"] > 0


def test_int8_ef_train_cell_gathers_no_leaf(mesh22):
    """At widths where every shard holds whole 256-element blocks the
    SPMD ``int8_ef`` step quantizes each shard where it lies: its
    collectives are the bf16 step's, and the record models the gradient
    reductions' wire at ``INT8_EF_WIRE_RATIO``."""
    cfg = dataclasses.replace(smoke_config("paper-lm-100m"), d_model=512,
                              n_heads=8, n_kv_heads=8, head_dim=64,
                              d_ff=1024, vocab=512)
    shape = shapes.ShapeSpec("train_smoke", "train", 64, 8, microbatches=2)
    shapes.SHAPES["train_smoke"] = shape
    try:
        recs = {t: dryrun.lower_cell(
            "paper-lm-100m", "train_smoke", False, grad_transport=t,
            device="cpu", config=cfg, mesh=mesh22)
            for t in ("bf16", "int8_ef")}
    finally:
        del shapes.SHAPES["train_smoke"]
    bf16, int8 = recs["bf16"], recs["int8_ef"]
    assert "int8_ef_gather" not in int8["collectives_by_kind"]
    assert int8["collectives"] == bf16["collectives"]
    coll = bf16["collectives"]
    grad = coll["all-reduce"]["wire_bytes_bf16eq"] \
        + coll["reduce-scatter"]["wire_bytes_bf16eq"]
    assert grad > 0
    r = int8["roofline"]
    assert r["collective_s"] == r["collective_s_int8"] < r["collective_s_bf16"]
    assert (r["collective_s_bf16"] - r["collective_s_int8"]) * 450e9 == \
        pytest.approx(grad * (1 - dryrun.INT8_EF_WIRE_RATIO))
    assert bf16["roofline"]["collective_s"] == r["collective_s_bf16"]


def test_int8_ef_shards_keep_the_one_device_blocks(mesh22):
    """``_whole_block_placements``: a shard that is a run of whole blocks
    keeps its placements; a dim whose shards cut a block is gathered, that
    dim only."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.analysis import fake_mode

    with fake_mode():
        whole = distribute_tensor(torch.empty(64, 512), mesh22,
                                  (Shard(0), Shard(1)), src_data_rank=None)
        assert step_lib._whole_block_placements(whole, 256) == \
            (Shard(0), Shard(1))
        cut = distribute_tensor(torch.empty(64, 128), mesh22,
                                (Shard(0), Shard(1)), src_data_rank=None)
        assert step_lib._whole_block_placements(cut, 256) == \
            (Shard(0), Replicate())
        tiny = distribute_tensor(torch.empty(4, 6), mesh22,
                                 (Shard(0), Replicate()), src_data_rank=None)
        assert step_lib._whole_block_placements(tiny, 256) == \
            (Replicate(), Replicate())


# ---------------------------------------------------------------------------
# one full-size cell
# ---------------------------------------------------------------------------

def test_full_size_lower_only_cells_equal_the_references(tmp_path,
                                                          reference_lowered):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", ",".join(FULL_SIZE), "--shape", "prefill_8k",
                     "--mesh", "pod", "--lower-only", "--device", "cpu",
                     "--out", str(tmp_path), "--force"])
    assert done.value.code == 0
    assert not dist.is_initialized()
    proc, out = reference_lowered
    _, err = proc.communicate(timeout=SUBPROCESS_S)
    assert proc.returncode == 0, err[-2000:]
    for arch in FULL_SIZE:
        name = f"{arch}__prefill_8k__16x16.json"
        got = json.loads((tmp_path / name).read_text())
        want = json.loads((out / name).read_text())
        assert got["status"] == want["status"] == "lowered"
        assert got["chips"] == want["chips"] == 256
        for k in ("params", "active_params", "kind", "preset",
                  "microbatches"):
            assert got[k] == want[k], (arch, k)
        for k in ("dot_flops", "hbm_bytes"):
            assert got["jaxpr_cost"][k] == want["jaxpr_cost"][k], (arch, k)


def test_main_writes_skip_records_and_counts_failures(tmp_path):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode",
                     "--mesh", "both", "--device", "cpu",
                     "--out", str(tmp_path)])
    assert done.value.code == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"hubert-xlarge__{s}__{m}.json"
                     for s in ("decode_32k", "long_500k")
                     for m in ("16x16", "2x16x16")]
    rec = json.loads((tmp_path / names[0]).read_text())
    assert rec["status"] == "skip"
    assert rec["skip_reason"] == "encoder-only arch: no decode step"
