"""Serving across ranks against the JAX package's serving.

One 4-rank gloo group on the CPU (``dist.spawn.run_ranks``) runs every
mesh path of ``repro_torch.launch.serve`` on smoke configs in f32, with
the reference's weights carried across by ``params_from_jax``, and
returns what each rank saw; the tests below hold it. Meanwhile a JAX
subprocess on 4 forced host devices runs the reference's
``disagg_decode_report`` on its (2, 2) mesh.

Tokens (``paper-lm-100m``, 8 ragged prompts of 8-16 tokens, 6 new):
  * colocated ``(data 2, model 2)`` under ``serve_sp`` against the
    reference's one-device tokens: at least half the rows equal, the bar
    of ``tests/test_serve_multidevice.py:171`` (measured: every row);
  * the int8 activation transport's tokens equal bf16's, and its
    ``act_gather_int8`` bytes are below ``act_gather_bf16``'s over 1.5 on
    every rank (measured 1.97x: f32 activations and the bf16 cache
    against s8 values and f32 scales);
  * disaggregated (prefill ranks 0-1, decode ranks 2-3, bf16 handoff)
    equals colocated, the criterion of ``tests/test_serve_disagg.py:128``;
    int8 handoff + int8 storage keeps at least half the rows of bf16
    (``:141``) and equals the reference's own int8 run on its degenerate
    (1, 1) meshes (measured: equal); its ``cache_move_int8`` bytes are
    below ``cache_move_bf16``'s over 1.5 (measured 1.69x on this small
    cache, whose 28-position rows are one block each);
  * slot streaming on the decode mesh (3 slots, 8 requests) and the paged
    fan-in on fan-in meshes (2 one-rank workers, 3 slots, eviction)
    equal colocated serving (``tests/test_serve_disagg.py:362-377``);
  * every rank returns the same tokens;
  * a config with one KV head (TP 2 > kv_heads) runs the KV replication
    of ``models/attention.py`` on the (2, 2) mesh and equals one device;
  * ``qwen3-moe-30b-a3b`` under ``ep`` with the int8 transport routes
    decode through ``expert_a2a`` on the mesh and equals the reference's
    one-device int8 tokens.
Layouts: the mesh partitions of ``tests/test_serve_disagg.py:65`` and
``:352``; each parameter's and cache leaf's local shard the shape
``resolve_spec`` gives. Collectives: ``all_gather_int8`` and
``stream_int8`` under the mesh give the one-device round trip's values
bit for bit, in the target layout, both where shards hold whole blocks
and where they do not. Reports: the port's ``disagg_decode_report`` has
every key of the reference's, the same ``cache_resident_bytes_per_device``
exactly, and the relations of ``TestDisaggDryrunReport``
(``tests/test_serve_disagg.py:276-335``). The launcher runs with
``--disagg`` and with ``--tp 2``, rank 0 printing the reference's lines.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.launch import serve as ref_serve
from repro.models import transformer as ref_tf
from repro_torch.configs import smoke_config
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.dist.spawn import run_ranks
from repro_torch.kernels.expert_a2a import ops as a2a_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.models import params_from_jax, transformer
from repro_torch.models.common import tree_leaves

ARCH, MOE = "paper-lm-100m", "qwen3-moe-30b-a3b"
B, S0, NEW = 8, 16, 6
REPORT = dict(batch=8, seq_len=512, blocks=(256, 128))
BW = dict(ici_bw=450e9, hbm_bw=3.35e12)
GROUP_S = 300

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


def inputs():
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, 256, size=(B, S0)).astype(np.int32)
    lens = rng.randint(8, S0 + 1, size=(B,)).astype(np.int32)
    return prompts, lens


def ref_params(arch: str, seed: int = 0):
    p = ref_tf.init_params(ref_smoke_config(arch), jax.random.PRNGKey(seed))
    return jax.tree.map(lambda x: x.astype(jnp.float32)
                        if x.dtype == jnp.bfloat16 else x, p)


def one_kv_head(cfg):
    return dataclasses.replace(cfg, n_kv_heads=1)


def _round_trip(x: torch.Tensor) -> torch.Tensor:
    q, s = coll.quantize_int8_lastdim(x)
    return coll.dequantize_int8_lastdim(q, s).to(x.dtype)


def _layouts(mesh, cfg, params, out):
    """Each leaf's local shard shape against ``resolve_spec``'s."""
    from torch.distributed.tensor import distribute_tensor

    rules = shd.PRESETS["serve_sp"]
    bad = []
    placed = shd.distribute_tree(params, transformer.param_axes(cfg), mesh,
                                 rules)
    for leaf, la in zip(tree_leaves(placed),
                        tree_leaves(transformer.param_axes(cfg),
                                    is_leaf=transformer.is_axes)):
        want = shd.local_shape(leaf.shape, shd.resolve_spec(
            leaf.shape, tuple(la), mesh, rules), mesh)
        if tuple(leaf.to_local().shape) != want:
            bad.append((tuple(la), tuple(leaf.to_local().shape), want))
    cache = transformer.init_cache(cfg, B, 512, device="cpu")
    for name, leaf in cache.items():
        la = transformer.cache_axes(cfg, B, 512)[name]
        spec = shd.resolve_spec(leaf.shape, la, mesh, rules)
        t = distribute_tensor(leaf, mesh, list(shd.placements(spec, mesh)),
                              src_data_rank=None)
        if tuple(t.to_local().shape) != shd.local_shape(leaf.shape, spec,
                                                        mesh):
            bad.append((name, tuple(t.to_local().shape)))
        out["cache_spec"] = spec
    out["layout_mismatches"] = bad


def _gathers(mesh, out):
    """all_gather_int8 and stream_int8 on the mesh against one device."""
    from torch.distributed.tensor import distribute_tensor

    gen = torch.Generator().manual_seed(3)
    res = {}
    with shd.axis_rules(mesh, shd.PRESETS["serve_sp"]):
        for s in (512, 48):            # whole blocks per shard, and not
            x = torch.randn((B, s, 512), generator=gen) * 3
            src = shd.placements(shd.resolve_spec(
                x.shape, ("batch", "seq_res", "act_embed"), mesh,
                shd.PRESETS["serve_sp"]), mesh)
            dt = distribute_tensor(x, mesh, list(src), src_data_rank=None)
            coll.reset_wire_bytes()
            y = coll.all_gather_int8(dt, "batch", None, "act_embed")
            want = coll.target_placements(x.shape, ("batch", None,
                                                    "act_embed"))
            res[f"gather{s}"] = (
                torch.equal(y.full_tensor(), _round_trip(x)),
                tuple(y.placements) == tuple(want),
                coll.wire_bytes())
    leaf = (torch.randn((2, B, 512, 2, 16), generator=gen) * 2).to(
        torch.bfloat16)
    for s in (512, 40):
        lf = leaf[:, :, :s].contiguous()
        axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        src = shd.placements(shd.resolve_spec(
            lf.shape, axes, mesh, shd.PRESETS["serve_sp"]), mesh)
        dt = distribute_tensor(lf, mesh, list(src), src_data_rank=None)
        want = coll.stream_int8(lf, *axes, seq_axis=2)      # one device
        with shd.axis_rules(mesh, shd.PRESETS["serve_decode"]):
            coll.reset_wire_bytes()
            y = coll.stream_int8(dt, *axes, seq_axis=2)
            tgt = coll.target_placements(lf.shape, axes)
        res[f"stream{s}"] = (torch.equal(y.full_tensor(), want),
                             tuple(y.placements) == tuple(tgt),
                             coll.wire_bytes())
    out["gathers"] = res


def _serve_rank(rank, world, init, params_np, moe_np):
    torch.set_num_threads(1)
    mesh_lib.init_ranks("gloo", rank=rank, world_size=world,
                        init_method=init, device="cpu")
    cfg, moe_cfg = smoke_config(ARCH), smoke_config(MOE)
    params = params_from_jax(cfg, params_np, device="cpu")
    moe_params = params_from_jax(moe_cfg, moe_np, device="cpu")
    prompts, lens = inputs()
    mesh = mesh_lib.make_local_mesh(model_parallel=2, device="cpu")
    pre, dec = serve.make_disagg_meshes(cfg, device="cpu")
    pres, fdec = serve.make_fanin_meshes(cfg, workers=2, device="cpu")
    out = {"meshes": {
        "colo": serve.mesh_ranks(mesh), "pre": serve.mesh_ranks(pre),
        "dec": serve.mesh_ranks(dec),
        "workers": [serve.mesh_ranks(m) for m in pres],
        "fanin_dec": serve.mesh_ranks(fdec),
        "dec_shape": shd.axis_sizes(dec)}}

    def run(name, **kw):
        coll.reset_wire_bytes()
        out[name] = serve.generate(cfg, params, prompts, max_new=NEW,
                                   prompt_lens=lens, **kw)
        out[name + "_wire"] = coll.wire_bytes()

    run("colo", mesh=mesh)
    run("colo_int8", mesh=mesh, act_transport="int8")
    run("disagg", mesh=pre, decode_mesh=dec)
    run("disagg_int8", mesh=pre, decode_mesh=dec, cache_transfer="int8",
        kv_storage="int8")
    run("slots", mesh=pre, decode_mesh=dec, stream="slots", slots=3)
    out["slots_stats"] = dict(serve._generate_slots.last_stats)
    run("fanin", mesh=pres[0], prefill_meshes=pres, decode_mesh=fdec,
        workers=2, slots=3, evict="oldest", paged=True)
    out["fanin_stats"] = dict(serve._generate_fanin.last_stats)

    kv1 = one_kv_head(cfg)
    attn = params["layers"]["attn"]
    p1 = {**params, "layers": {**params["layers"], "attn": {
        **attn, "wk": attn["wk"][..., :1, :], "wv": attn["wv"][..., :1, :]}}}
    out["kv1_single"] = serve.generate(kv1, p1, prompts, max_new=NEW,
                                       prompt_lens=lens)
    out["kv1_colo"] = serve.generate(kv1, p1, prompts, max_new=NEW,
                                     prompt_lens=lens, mesh=mesh)

    a2a_ops.reset_calls()
    coll.reset_wire_bytes()
    out["moe_ep_int8"] = serve.generate(
        moe_cfg, moe_params, prompts[:, :8], max_new=4, mesh=mesh,
        rules=shd.PRESETS["ep"], act_transport="int8")
    out["moe_a2a_calls"] = a2a_ops.calls()
    out["moe_wire"] = coll.wire_bytes()

    _layouts(mesh, cfg, params, out)
    _gathers(mesh, out)
    rep = serve.disagg_decode_report(cfg, REPORT["batch"],
                                     REPORT["seq_len"], mesh,
                                     blocks=REPORT["blocks"],
                                     params=params, **BW)
    out["report"] = json.loads(json.dumps(rep, default=str))

    for argv in (["--disagg"], ["--tp", "2", "--act-transport", "int8"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(["--arch", ARCH, "--device", "cpu", "--max-new", "4",
                        "--batch", "4", "--prompt-len", "16"] + argv)
        out["main " + " ".join(argv)] = buf.getvalue()
    return out


@pytest.fixture(scope="module")
def reference_report(tmp_path_factory):
    """The reference's report on its (2, 2) mesh, from a JAX subprocess
    started before the ranks and read after them."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(p) for p in sys.path if p] + [env.get("PYTHONPATH", "")])
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE_REPORT, ARCH],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference_report):
    params_np = jax.tree.map(np.asarray, ref_params(ARCH))
    moe_np = jax.tree.map(np.asarray, ref_params(MOE))
    return run_ranks(_serve_rank, 4, params_np, moe_np, timeout=GROUP_S,
                     tmp_dir=str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def reference(reference_report):
    """The reference's one-device tokens and its degenerate (1, 1)
    disaggregated int8 run, on the same weights and prompts."""
    rcfg = ref_smoke_config(ARCH)
    rp = ref_params(ARCH)
    prompts, lens = inputs()
    pre, dec = ref_serve.make_disagg_meshes(rcfg)
    moe = ref_smoke_config(MOE)
    return {
        "single": ref_serve.generate(rcfg, rp, prompts, max_new=NEW,
                                     prompt_lens=lens),
        "disagg_int8": ref_serve.generate(
            rcfg, rp, prompts, max_new=NEW, prompt_lens=lens, mesh=pre,
            decode_mesh=dec, cache_transfer="int8", kv_storage="int8"),
        "moe_int8": ref_serve.generate(moe, ref_params(MOE),
                                       prompts[:, :8], max_new=4,
                                       act_transport="int8"),
    }


def rows_equal(a, b) -> float:
    return float((a == b).all(axis=1).mean())


# ---------------------------------------------------------------------------
# meshes and layouts
# ---------------------------------------------------------------------------

def test_disagg_meshes_are_disjoint_halves(ranks):
    m = ranks[0]["meshes"]
    assert set(m["pre"]).isdisjoint(m["dec"])
    assert len(m["pre"]) == len(m["dec"]) == 2
    assert m["dec_shape"] == {"data": 1, "model": 2}
    assert m["colo"] == (0, 1, 2, 3)
    assert all(r["meshes"] == m for r in ranks)


def test_fanin_worker_meshes_partition_the_prefill_half(ranks):
    m = ranks[0]["meshes"]
    w0, w1 = (set(w) for w in m["workers"])
    assert w0 and w1 and w0.isdisjoint(w1)
    assert (w0 | w1) == set(m["pre"])
    assert all(w.isdisjoint(m["fanin_dec"]) for w in (w0, w1))


def test_local_shards_are_resolve_specs(ranks):
    for r in ranks:
        assert r["layout_mismatches"] == []
    # serve_sp: batch over data, the cache's sequence over model
    assert ranks[0]["cache_spec"] == (None, "data", "model")


def test_one_process_meshes_are_the_degenerate_pair():
    cfg = smoke_config(ARCH)
    pre, dec = serve.make_disagg_meshes(cfg, device="cpu")
    pres, fdec = serve.make_fanin_meshes(cfg, 2, device="cpu")
    assert shd.axis_sizes(pre) == shd.axis_sizes(dec) == \
        {"data": 1, "model": 1}
    assert len(pres) == 2 and shd.axis_sizes(fdec) == {"data": 1, "model": 1}
    assert serve._pick_tp(4, cfg) == 2 and serve._pick_tp(3, cfg) == 1


# ---------------------------------------------------------------------------
# the int8 gathers under a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["gather512", "gather48", "stream512",
                                  "stream40"])
def test_int8_gathers_equal_the_one_device_round_trip(ranks, case):
    """Bit for bit, in the target layout; the s8 payload is what crosses
    (a shard of 48 or 40 positions holds no whole block, so it is
    gathered first and the wire carries its raw shard too)."""
    for r in ranks:
        same, layout, wire = r["gathers"][case]
        assert same and layout, (case, wire)
        kind = "act_gather_int8" if case.startswith("gather") \
            else "cache_stream_int8"
        assert wire.get(kind, 0) > 0, wire


# ---------------------------------------------------------------------------
# tokens
# ---------------------------------------------------------------------------

def test_every_rank_returns_the_same_tokens(ranks):
    for name in ("colo", "colo_int8", "disagg", "disagg_int8", "slots",
                 "fanin", "kv1_colo", "moe_ep_int8"):
        for r in ranks[1:]:
            assert np.array_equal(r[name], ranks[0][name]), name


def test_colocated_mesh_tracks_the_reference_single_device(ranks, reference):
    got = ranks[0]["colo"]
    assert got.shape == (B, NEW) and got.dtype == np.int32
    assert rows_equal(got, reference["single"]) >= 0.5, \
        (got, reference["single"])


def test_int8_act_transport_tokens_equal_bf16_and_move_fewer_bytes(ranks):
    assert np.array_equal(ranks[0]["colo_int8"], ranks[0]["colo"])
    for r in ranks:
        bf16 = r["colo_wire"]["act_gather_bf16"]
        int8 = r["colo_int8_wire"]["act_gather_int8"]
        assert 0 < int8 <= bf16 / 1.5, (int8, bf16)


def test_disaggregated_bf16_equals_colocated(ranks):
    assert np.array_equal(ranks[0]["disagg"], ranks[0]["colo"])


def test_disaggregated_int8_equals_the_reference_degenerate_run(ranks,
                                                                reference):
    got = ranks[0]["disagg_int8"]
    assert np.array_equal(got, reference["disagg_int8"]), \
        (got, reference["disagg_int8"])
    assert rows_equal(got, ranks[0]["disagg"]) >= 0.5


def test_int8_handoff_moves_fewer_bytes(ranks):
    for r in ranks[:2]:                   # the prefill ranks send
        bf16 = r["disagg_wire"]["cache_move_bf16"]
        int8 = r["disagg_int8_wire"]["cache_move_int8"]
        assert 0 < int8 <= bf16 / 1.5, (int8, bf16)
    for r in ranks[2:]:                   # the decode ranks only receive
        assert "cache_move_bf16" not in r["disagg_wire"]


def test_slot_streaming_on_the_decode_mesh_equals_colocated(ranks):
    assert np.array_equal(ranks[0]["slots"], ranks[0]["colo"])
    assert ranks[0]["slots_stats"]["admissions"] == B
    assert all(r["slots_stats"]["decode_steps"]
               == ranks[0]["slots_stats"]["decode_steps"] for r in ranks)


def test_paged_fanin_across_fanin_meshes_equals_colocated(ranks):
    assert np.array_equal(ranks[0]["fanin"], ranks[0]["colo"])
    st = ranks[0]["fanin_stats"]
    assert st["admissions"] >= B
    for r in ranks:              # each rank's own wait differs, not the rest
        assert {k: v for k, v in r["fanin_stats"].items()
                if k != "transfer_wait_s"} == \
            {k: v for k, v in st.items() if k != "transfer_wait_s"}


def test_kv_replication_when_tp_exceeds_kv_heads(ranks):
    assert np.array_equal(ranks[0]["kv1_colo"], ranks[0]["kv1_single"])


def test_moe_expert_parallel_int8_decode(ranks, reference):
    r = ranks[0]
    assert np.array_equal(r["moe_ep_int8"], reference["moe_int8"])
    # one call per layer per decode step (4 new tokens: 3 decode steps
    # feed the next token, the last one's logits go unused)
    assert r["moe_a2a_calls"] == smoke_config(MOE).n_layers * 4


# ---------------------------------------------------------------------------
# the reports and the launcher
# ---------------------------------------------------------------------------

def test_disagg_report_matches_the_reference(ranks, reference_report):
    out, err = reference_report.communicate(timeout=GROUP_S)
    assert reference_report.returncode == 0, err[-2000:]
    want = json.loads(out.strip().splitlines()[-1])
    got = ranks[0]["report"]
    assert set(got) == set(want)
    assert set(got["cells"]) == set(want["cells"])
    for name, cell in got["cells"].items():
        assert set(cell) == set(want["cells"][name])
        assert cell["cache_resident_bytes_per_device"] == \
            want["cells"][name]["cache_resident_bytes_per_device"]
    assert set(got["slot_stream"]) == set(want["slot_stream"])
    assert got["hide_steps"] == want["hide_steps"]
    assert got["unsupported_storage"] == want["unsupported_storage"] == []


def test_disagg_report_relations(ranks):
    """``TestDisaggDryrunReport``'s assertions, on the port's report."""
    rep = ranks[0]["report"]
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
    assert set(sweep) == {"128", "256"}
    assert sweep["128"]["transfer_wire_bytes_bf16eq"] \
        >= sweep["256"]["transfer_wire_bytes_bf16eq"]
    tuned = rep["tuned"]
    assert tuned["point"]["cache_transfer"] in ("bf16", "int8")
    assert tuned["point"]["kv_storage"] in ("bf16", "int8", "f8")
    assert tuned["point"]["block"] in (128, 256)
    assert tuned["collective_s"] > 0 and tuned["evaluations"] >= 1


def test_launcher_disagg_on_four_ranks(ranks):
    text = ranks[0]["main --disagg"]
    assert "mesh={'prefill': {'data': 1, 'model': 2}, " \
        "'decode': {'data': 1, 'model': 2}}" in text
    assert "disagg=True" in text and "[serve] sample:" in text
    assert ranks[1]["main --disagg"] == ""            # rank 0 prints


def test_launcher_tp2_on_four_ranks(ranks):
    text = ranks[0]["main --tp 2 --act-transport int8"]
    assert "mesh={'data': 2, 'model': 2}" in text
    assert "act_transport=int8" in text and "generated 16 tokens" in text
