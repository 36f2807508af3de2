"""Dry run on the production meshes: each (arch x shape x mesh x preset)
cell's cost, collectives and roofline, with no pod and no weights.

The port of ``src/repro/launch/dryrun.py``. The reference lowers and
compiles each cell's step for 256 or 512 forced host devices and reads
the compiled program. The port has no compiler to ask, so one process
joins a *fake* process group (``torch.distributed``'s ``"fake"``
backend: every collective returns at once and moves nothing) of 256 or
512 ranks as rank 0, builds the ``(16, 16)`` or ``(2, 16, 16)``
``DeviceMesh`` over it (``launch/mesh.py::make_production_mesh``) and
runs the step on fake tensors (``FakeTensorMode``: shapes and dtypes, no
data, no device work) on ``--device`` (the card unless the caller names
another; nothing runs on it):

- ``jaxpr_cost``: ``analysis.jaxpr_cost`` of the one-device step under
  the mesh's axis sizes (:func:`cost_walk`), the global cost the
  reference's jaxpr walk gives. DTensor ops count one rank's local work,
  so the sharded step is not walked for it.
- ``collectives``: the DTensor step on the mesh under
  ``analysis.CollectiveMode``: one rank's collectives by the reference's
  five HLO op names and keys (a skipped ``--lower-only`` cell has none).
  DTensor and GSPMD choose their collectives each their own way, so the
  counts are the port's program's, not the reference's.
- ``roofline``: the reference's terms with an H100's constants.
- decode cells: the ``disagg`` and ``fanin`` blocks from
  ``launch.serve.disagg_decode_report`` (priced by the same collective
  meter) and ``fanin_report``.

A train step carries gradients through every layer, so its walks cannot
replay a layer from the first one's counts (``models.common.repeated``
replays only bodies with no gradient to carry). It is walked at one, two
(and, for the cost, three) remat units of depth and interpolated to the
config's depth (:func:`_by_depth`), which is exact: units are
identical.

The reference's fields with no counterpart here: ``lower_s``,
``compile_s``, ``compile_other_transport_s``, ``memory_analysis``,
``cost_analysis`` and the HLO text. Each record carries ``wall_s``, the
cell's seconds on the host, and ``collectives_s`` for the mesh trace.

    python -m repro_torch.launch.dryrun --arch paper-lm-100m \\
        --shape train_4k --mesh pod --device cpu --force
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from fractions import Fraction
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs import shapes as shapes_lib
from repro_torch.dist import sharding as shd
from repro_torch.launch import analysis
from repro_torch.launch import serve as serve_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer
from repro_torch.models.common import resolve_device
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib

# --- NVIDIA H100 SXM (per GPU), datasheet figures, not measurements ------
PEAK_FLOPS = 989e12        # dense bf16 FLOP/s
HBM_BW = 3.35e12           # HBM3 bytes/s
# NVLink 4, bytes/s per direction per GPU. NVLink joins the 8 GPUs of one
# node; a 16-wide mesh axis spans two nodes, whose traffic crosses the
# slower inter-node network, so this figure is an upper bound on the link
# rate and collective_s a lower bound.
LINK_BW = 450e9

COLLECTIVE_OPS = analysis.COLLECTIVE_OPS
model_flops = analysis.model_flops

# Wire ratio of the two-stage int8 exchange vs a ring bf16 all-reduce for
# the same payload: (1 int8 byte + f32 scale per block) on each of the two
# stages, against 2 bf16 bytes on each of the two ring phases.
INT8_EF_WIRE_RATIO = (1 + 4 / 256) / 2

# Traced serve-cell collectives, keyed by the cell variant + act
# transport: in an --act-transport both sweep each program is the sibling
# cell's counterpart, so each distinct serve program is traced once.
_SERVE_COLL_MEMO: Dict[tuple, Dict[str, Any]] = {}

# Disaggregated-decode reports, memoized the same way: the report does not
# depend on the record's own preset or act_transport.
_DISAGG_MEMO: Dict[tuple, Dict[str, Any]] = {}


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

def fake_world(world: int) -> int:
    """Join (or keep) a fake process group of ``world`` ranks as rank 0
    (the production mesh needs 256, or 512 for two pods). A fake group of
    another size is replaced; a real group is refused."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs its own fake process "
                               "group; this process is in a real one")
        if dist.get_world_size() == world:
            return world
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())
    return world


def leave_fake_world() -> None:
    """Destroy the fake process group, if this process is in one."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the walks
# ---------------------------------------------------------------------------

def _unit(cfg) -> int:
    """Layers per repeated unit: a remat block, or an xLSTM period (one
    mLSTM block and its sLSTM blocks)."""
    return cfg.mlstm_every if cfg.family == "ssm_xlstm" \
        else max(1, cfg.remat_block)


def _weighted(trees, weights):
    """``sum(w * tree)`` over trees of numbers (dicts; a key missing from
    a tree counts 0 there)."""
    if any(isinstance(t, dict) for t in trees):
        keys = {k: None for t in trees for k in t}
        return {k: _weighted([t.get(k, 0) for t in trees], weights)
                for k in keys}
    return sum(w * t for w, t in zip(weights, trees))


def _by_depth(cfg, walk, degree: int = 1):
    """``walk(cfg)`` of a train step at the config's depth, from walks at
    1 .. ``degree + 1`` repeated units: a tree of counts that is a
    polynomial of that degree in the number of units (every unit is the
    same program), interpolated exactly. The collectives are linear; the
    cost is quadratic, since autograd sums each layer's gradient of a
    stacked leaf into the whole stacked leaf (one add of every layer's
    size per layer), where the reference's scan writes slices."""
    unit = _unit(cfg)
    units = cfg.n_layers // unit
    if units <= degree + 1 or cfg.n_layers % unit:
        return walk(cfg)
    xs = range(1, degree + 2)
    walks = [walk(dataclasses.replace(cfg, n_layers=x * unit)) for x in xs]
    weights = []
    for i in xs:                                # Lagrange, integer here
        w = Fraction(1)
        for j in xs:
            if j != i:
                w *= Fraction(units - j, i - j)
        weights.append(int(w))
    return _weighted(walks, weights)


def _mesh_key(mesh) -> tuple:
    return (mesh.device_type, tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def _step_args(cfg, shape, kind, grad_transport, device, mesh=None,
               rules=None):
    """The step's arguments: ``TensorSpec`` trees without a mesh; with
    one, fake tensors on ``device`` laid out on ``mesh`` by ``rules`` as
    DTensors (call inside a ``FakeTensorMode``)."""
    dev = torch.device(device)
    p_abs = transformer.abstract_params(cfg)
    p_axes = transformer.param_axes(cfg)
    batch_sds, cache_sds = shapes_lib.input_specs(cfg, shape)
    b_axes = shapes_lib.batch_axes(cfg, shape)

    def place(tree, axes):
        if mesh is None:
            return tree
        return shd.distribute_tree(analysis.fake_tree(tree, dev), axes,
                                   mesh, rules)

    params = place(p_abs, p_axes)
    if kind == "train":
        ef = grad_transport == "int8_ef"
        state = place(opt_lib.abstract_state(p_abs, error_feedback=ef),
                      opt_lib.state_axes(p_axes, error_feedback=ef))
        # the SPMD step takes the global batch and enters its own rows
        batch = batch_sds if mesh is None else \
            analysis.fake_tree(batch_sds, dev)
        return params, state, batch
    batch = place(batch_sds, b_axes)
    if kind in ("prefill", "encode"):
        return params, batch
    c_axes = transformer.cache_axes(cfg, shape.global_batch, shape.seq_len)
    return params, place(cache_sds, c_axes), batch


def cost_walk(cfg, shape, *, grad_transport: str = "bf16",
              act_transport: str = "bf16", device="cpu", mesh=None,
              rules=None) -> Dict[str, float]:
    """``analysis.jaxpr_cost`` of the cell's one-device step. With a
    ``mesh`` the step runs under ``axis_rules`` of the mesh's axis sizes
    (a mapping, not the mesh: the tensors stay whole), as the reference
    walks its step under the mesh's rules, so that the model's choices
    that read the mesh (attention replicates K/V heads up to the model
    axis) are the reference's."""
    ctx = contextlib.nullcontext() if mesh is None else \
        shd.axis_rules(shd.axis_sizes(mesh), rules)

    def walk(c):
        with ctx:
            fn, kind = step_lib.step_for_shape(
                c, shape, grad_transport=grad_transport,
                act_transport=act_transport)
            args = _step_args(c, shape, kind, grad_transport, device)
            return analysis.jaxpr_cost(fn, *args, device=device)

    if shape.kind == "train":
        return _by_depth(cfg, walk, degree=2)
    return walk(cfg)


def collective_walk(cfg, shape, mesh, rules, *, grad_transport: str = "bf16",
                    act_transport: str = "bf16", device="cpu"
                    ) -> Dict[str, Any]:
    """One rank's collectives of the cell's step on ``mesh`` under
    ``rules``: ``{"ops": the reference's keys and totals, "kinds": the
    same rows by the port's redistribution kind}``."""
    def walk(c):
        with analysis.fake_mode(), shd.axis_rules(mesh, rules):
            fn, kind = step_lib.step_for_shape(
                c, shape, grad_transport=grad_transport,
                act_transport=act_transport)
            args = _step_args(c, shape, kind, grad_transport, device,
                              mesh, rules)
            _, coll, kinds = analysis.trace_collectives(lambda: fn(*args))
        return {"ops": coll, "kinds": kinds}

    if shape.kind == "train":
        return _by_depth(cfg, walk)
    return walk(cfg)


def _disagg(cfg, shape, mesh, device, transfers, storages, blocks):
    """``disagg_decode_report`` on fake tensors on ``mesh``."""
    with analysis.fake_mode():
        params = analysis.fake_tree(transformer.abstract_params(cfg),
                                    torch.device(device))
        return serve_lib.disagg_decode_report(
            cfg, shape.global_batch, shape.seq_len, mesh, ici_bw=LINK_BW,
            hbm_bw=HBM_BW, transfers=transfers, storages=storages,
            blocks=blocks, params=params)


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               skip_compile: bool = False, preset: str = "baseline",
               microbatches: Optional[int] = None,
               remat_block: Optional[int] = None,
               capacity_factor: Optional[float] = None,
               grad_transport: str = "bf16",
               act_transport: str = "bf16",
               cache_transfers: tuple = ("bf16", "int8"),
               kv_storages: tuple = ("bf16", "int8"),
               stream_blocks: tuple = (256,),
               workers: int = 2,
               page_size: int = 0,
               device=None, config=None, mesh=None) -> Dict[str, Any]:
    """The reference's record for one cell (see the module's docstring
    for what each field is here); ``skip_compile`` is ``--lower-only``:
    the cost walk alone, ``status: "lowered"``. ``config`` (a
    ``ModelConfig`` in place of ``arch``'s, e.g. a smoke config) and
    ``mesh`` (a ``DeviceMesh`` in place of the production mesh, in a
    process group the caller made) size a cell down."""
    t_cell = time.time()
    dev = resolve_device(device, "lower_cell")
    cfg = get_config(arch) if config is None else config
    if remat_block is not None:
        cfg = dataclasses.replace(cfg, remat_block=remat_block)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    shape = shapes_lib.SHAPES[shape_name]
    if microbatches is not None and shape.kind == "train":
        shape = dataclasses.replace(shape, microbatches=microbatches)
    rules = shd.PRESETS[preset]
    is_train = shape.kind == "train"
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind, "preset": preset,
        "grad_transport": grad_transport if is_train else None,
        "act_transport": None if is_train else act_transport,
        "microbatches": shape.microbatches,
        "remat_block": cfg.remat_block,
        "capacity_factor": cfg.capacity_factor,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    ok, why = shapes_lib.applicable(cfg, shape)
    if not ok:
        rec["status"] = "skip"
        rec["skip_reason"] = why
        return rec

    if mesh is None:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
    n_chips = int(mesh.size())
    rec["chips"] = n_chips
    _, kind = step_lib.step_for_shape(cfg, shape,
                                      grad_transport=grad_transport,
                                      act_transport=act_transport)

    # the one-device step's global cost -> per device
    t0 = time.time()
    jc = cost_walk(cfg, shape, grad_transport=grad_transport,
                   act_transport=act_transport, device=dev, mesh=mesh,
                   rules=rules)
    rec["jaxpr_cost"] = jc
    rec["jaxpr_cost_s"] = round(time.time() - t0, 2)

    if skip_compile:
        rec["status"] = "lowered"
        rec["wall_s"] = round(time.time() - t_cell, 2)
        return rec

    t0 = time.time()
    walked = collective_walk(cfg, shape, mesh, rules,
                             grad_transport=grad_transport,
                             act_transport=act_transport, device=dev)
    rec["collectives_s"] = round(time.time() - t0, 2)
    coll = rec["collectives"] = walked["ops"]
    rec["collectives_by_kind"] = walked["kinds"]

    flops_dev = jc["flops"] / n_chips          # analytic, every repeat counted
    bytes_dev = jc["hbm_bytes"] / n_chips      # dot-operand HBM traffic model
    # one rank's link traffic (ring wire model), f32 payloads at bf16
    # bytes as the reference prices them
    coll_dev = float(coll["total_wire_bytes_bf16eq"])
    if kind == "train":
        # int8-vs-bf16 gradient transport: the SPMD step reduces each
        # gradient in bf16 (the reduce-scatters and all-reduces that lay
        # it out as its parameter) and then quantizes each shard in place,
        # so the int8_ef transport's wire is modeled on those reductions,
        # as the reference models it; everything else is unchanged
        grad_wire = float(coll["all-reduce"]["wire_bytes_bf16eq"]
                          + coll["reduce-scatter"]["wire_bytes_bf16eq"])
        coll_bf16_dev = coll_dev
        coll_int8_dev = coll_dev - grad_wire * (1 - INT8_EF_WIRE_RATIO)
        coll_own_dev = coll_int8_dev if grad_transport == "int8_ef" \
            else coll_bf16_dev
    else:
        # serve cells: the act_transport comparison is measured, not
        # modeled: the other transport's program is traced too
        cell = (cfg, shape_name, _mesh_key(mesh), preset, str(dev))
        _SERVE_COLL_MEMO[cell + (act_transport,)] = walked
        other = "int8" if act_transport == "bf16" else "bf16"
        walked2 = _SERVE_COLL_MEMO.get(cell + (other,))
        if walked2 is None:
            t0 = time.time()
            walked2 = collective_walk(cfg, shape, mesh, rules,
                                      act_transport=other, device=dev)
            rec["collectives_other_transport_s"] = round(time.time() - t0, 2)
            _SERVE_COLL_MEMO[cell + (other,)] = walked2
        by_t = {act_transport: walked, other: walked2}
        rec["other_transport"] = {"act_transport": other,
                                  "collectives": walked2["ops"],
                                  "collectives_by_kind": walked2["kinds"]}
        coll_bf16_dev = float(by_t["bf16"]["ops"]["total_wire_bytes_bf16eq"])
        coll_int8_dev = float(by_t["int8"]["ops"]["total_wire_bytes_bf16eq"])
        coll_own_dev = coll_dev
        rec["act_gather_wire_bytes_bf16eq_s8"] = \
            int(by_t["int8"]["ops"]["total_wire_bytes_bf16eq_s8"])
        # the activation gathers alone, under each transport's program
        rec["act_gather_wire_bytes_bf16eq"] = {
            t: by_t[t]["kinds"].get(f"act_gather_{t}", {}).get(
                "wire_bytes_bf16eq", 0) for t in ("bf16", "int8")}
    mf = model_flops(cfg, shape)
    terms = {
        "compute_s": flops_dev / PEAK_FLOPS,
        "memory_s": bytes_dev / HBM_BW,
        "collective_s": coll_own_dev / LINK_BW,
    }
    dom = max(terms, key=terms.get)
    bound_s = terms[dom]
    rec["roofline"] = {
        **terms,
        "collective_s_bf16": coll_bf16_dev / LINK_BW,
        "collective_s_int8": coll_int8_dev / LINK_BW,
        "dominant": dom,
        "model_flops": mf,
        "model_flops_per_device": mf / n_chips,
        "hlo_flops_per_device": flops_dev,
        "useful_flops_ratio": (mf / n_chips) / flops_dev if flops_dev else None,
        "roofline_fraction": ((mf / n_chips) / PEAK_FLOPS) / bound_s
        if bound_s else None,
    }
    if kind == "decode":
        # disaggregated serving design space (see serve.disagg_decode_report)
        dkey = (cfg, shape_name, _mesh_key(mesh), cache_transfers, kv_storages,
                stream_blocks, str(dev))
        rep = _DISAGG_MEMO.get(dkey)
        if rep is None:
            t0 = time.time()
            rep = _disagg(cfg, shape, mesh, dev, cache_transfers,
                          kv_storages, stream_blocks)
            rep["trace_s"] = round(time.time() - t0, 2)
            _DISAGG_MEMO[dkey] = rep
        rec["disagg"] = rep
        rec["skipped_families"] = [
            {"family": cfg.family, "flag": flag, "reason": why}
            for flag, why in sorted(rep.get("skipped", {}).items())]
        for name, cell in rep["cells"].items():
            rec["roofline"]["disagg_collective_s_" + name] = \
                cell["collective_s"]
            t, s = name.split("x")
            rec["roofline"]["disagg_transfer_s_" + t] = cell["transfer_s"]
            rec["roofline"]["disagg_decode_step_s_" + s] = \
                cell["decode_step_s"]
            if "slot_stream_overlap_frac" in cell:
                rec["roofline"]["slot_stream_overlap_frac_" + name] = \
                    cell["slot_stream_overlap_frac"]
        for t, ss in rep["slot_stream"].items():
            rec["roofline"]["slot_stream_transfer_s_" + t] = \
                ss["transfer_s"]
            rec["roofline"]["slot_stream_wire_bytes_" + t] = \
                ss["wire_bytes_bf16eq"]
        if rep["tuned"] is not None:
            rec["roofline"]["disagg_tuned_collective_s"] = \
                rep["tuned"]["collective_s"]
        # fan-in arbitration roofline, priced with this cell's decode-step
        # and per-slot transfer costs
        cell0 = next(iter(rep["cells"].values()), None)
        ss0 = next(iter(rep["slot_stream"].values()), None)
        frep = serve_lib.fanin_report(
            cfg, shape.global_batch, shape.seq_len,
            workers=workers, page=page_size,
            decode_step_s=cell0["decode_step_s"] if cell0 else 0.0,
            transfer_s=ss0["transfer_s"] if ss0 else 0.0)
        rec["fanin"] = frep
        rec["roofline"]["fanin_admission_wait_s"] = \
            frep["fanin_admission_wait_s"]
        rec["roofline"]["fanin_evictions"] = float(frep["fanin_evictions"])
        if "paged_hbm_bytes_per_slot" in frep:
            rec["roofline"]["paged_hbm_bytes_per_slot"] = \
                frep["paged_hbm_bytes_per_slot"]
        rec["skipped_families"] += [
            {"family": cfg.family, "flag": flag, "reason": why}
            for flag, why in sorted(frep.get("skipped", {}).items())]
    rec["status"] = "ok"
    rec["wall_s"] = round(time.time() - t_cell, 2)
    return rec


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all",
                    help="comma list of shape names and/or kinds "
                         "(train/prefill/decode) or 'all'")
    ap.add_argument("--mesh", default="both", choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--lower-only", action="store_true",
                    help="the one-device cost walk only (status 'lowered'), "
                         "no trace on the mesh")
    ap.add_argument("--preset", default="baseline",
                    help="comma-separated preset names or 'all' "
                         f"(known: {','.join(sorted(shd.PRESETS))})")
    ap.add_argument("--grad-transport", default="bf16",
                    choices=["bf16", "int8_ef", "both"],
                    help="gradient transport for train cells; 'both' sweeps "
                         "the two and the records carry the collective_s "
                         "int8-vs-bf16 comparison either way")
    ap.add_argument("--act-transport", default="bf16",
                    choices=["bf16", "int8", "both"],
                    help="activation transport for serve (prefill/decode) "
                         "cells; every traced serve record carries the "
                         "measured collective_s bf16-vs-int8 comparison "
                         "(both transports are traced either way)")
    ap.add_argument("--cache-transfer", default="bf16,int8",
                    help="comma list of disagg cache-stream wire formats "
                         "for decode cells, or 'all' "
                         f"(known: {','.join(step_lib.CACHE_TRANSFERS)})")
    ap.add_argument("--kv-storage", default="bf16,int8",
                    help="comma list of decode-resident cache storage arms "
                         "for decode cells, or 'all' "
                         f"(known: {','.join(step_lib.KV_STORAGES)})")
    ap.add_argument("--stream-block", default="256",
                    help="comma list of cache-stream quantization block "
                         "sizes (positions per s8 chunk) to sweep; the "
                         "first is the one the combo cells report")
    ap.add_argument("--workers", type=int, default=2,
                    help="prefill workers for the decode cells' fan-in "
                         "arbitration roofline (serve.fanin_report)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="page size for the decode cells' paged-vs-dense "
                         "slot HBM comparison (0 = the tuned paged_attn "
                         "point, capped to 8 pages per row)")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat-block", type=int, default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors and the mesh (the "
                         "card by default; nothing runs on it)")
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    try:
        shapes = shapes_lib.expand_shape_names(args.shape)
    except KeyError as e:
        ap.error(str(e))
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    presets = sorted(shd.PRESETS) if args.preset == "all" \
        else args.preset.split(",")
    for p in presets:
        if p not in shd.PRESETS:
            ap.error(f"unknown preset {p!r}; known: {sorted(shd.PRESETS)}")
    grad_transports = ["bf16", "int8_ef"] if args.grad_transport == "both" \
        else [args.grad_transport]
    act_transports = ["bf16", "int8"] if args.act_transport == "both" \
        else [args.act_transport]

    def arm(value: str, known, flag: str) -> tuple:
        names = list(known) if value == "all" else value.split(",")
        for n in names:
            if n not in known:
                ap.error(f"unknown {flag} {n!r}; known: {list(known)}")
        return tuple(names)

    args.cache_transfers = arm(args.cache_transfer,
                               step_lib.CACHE_TRANSFERS, "--cache-transfer")
    args.kv_storages = arm(args.kv_storage, step_lib.KV_STORAGES,
                           "--kv-storage")
    try:
        args.stream_blocks = tuple(
            int(b) for b in args.stream_block.split(","))
    except ValueError:
        ap.error(f"--stream-block expects comma-separated ints, got "
                 f"{args.stream_block!r}")
    if any(b < 1 for b in args.stream_blocks):
        ap.error("--stream-block sizes must be positive")
    os.makedirs(args.out, exist_ok=True)

    failures = 0
    try:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    for preset in presets:
                        is_train = shapes_lib.SHAPES[shape].kind == "train"
                        sweep = grad_transports if is_train \
                            else act_transports
                        for transport in sweep:
                            failures += run_one(
                                args, arch, shape, mp, preset, transport)
    finally:
        leave_fake_world()
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


def run_one(args, arch: str, shape: str, mp: bool, preset: str,
            transport: str) -> int:
    is_train = shapes_lib.SHAPES[shape].kind == "train"
    parts = []
    if preset != "baseline":
        parts.append(preset)
    if transport != "bf16":
        parts.append(transport if is_train else f"act_{transport}")
    if args.microbatches:
        parts.append(f"mb{args.microbatches}")
    if args.remat_block:
        parts.append(f"rb{args.remat_block}")
    if args.capacity_factor:
        parts.append(f"cf{args.capacity_factor}")
    variant = ("__" + "-".join(parts)) if parts else ""
    tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}" + variant
    path = os.path.join(args.out, tag + ".json")
    if os.path.exists(path) and not args.force:
        print(f"[cached] {tag}")
        return 0
    print(f"[dryrun] {tag} ...", flush=True)
    failed = 0
    try:
        rec = lower_cell(arch, shape, mp,
                         skip_compile=args.lower_only,
                         preset=preset,
                         microbatches=args.microbatches,
                         remat_block=args.remat_block,
                         capacity_factor=args.capacity_factor,
                         grad_transport=transport if is_train else "bf16",
                         act_transport="bf16" if is_train else transport,
                         cache_transfers=args.cache_transfers,
                         kv_storages=args.kv_storages,
                         stream_blocks=args.stream_blocks,
                         workers=args.workers,
                         page_size=args.page_size,
                         device=args.device)
    except Exception as e:  # a failure here is a bug in the system
        rec = {"arch": arch, "shape": shape,
               "mesh": "2x16x16" if mp else "16x16",
               "status": "error", "error": repr(e),
               "traceback": traceback.format_exc()[-4000:]}
        failed = 1
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = rec.get("status")
    if status == "ok":
        r = rec["roofline"]
        coll_cmp = ""
        if "collective_s_bf16" in r:
            coll_cmp = (f"coll_bf16={r['collective_s_bf16']:.4f}s "
                        f"coll_int8={r['collective_s_int8']:.4f}s ")
        print(f"  ok: wall={rec['wall_s']}s "
              f"dom={r['dominant']} "
              f"compute={r['compute_s']:.4f}s "
              f"mem={r['memory_s']:.4f}s "
              f"coll={r['collective_s']:.4f}s "
              + coll_cmp +
              f"frac={r['roofline_fraction'] and round(r['roofline_fraction'], 3)}",
              flush=True)
    elif status == "lowered":
        print(f"  lowered: wall={rec['wall_s']}s "
              f"dot_flops={rec['jaxpr_cost']['dot_flops']:.6g}", flush=True)
    else:
        print(f"  {status}: {rec.get('skip_reason') or rec.get('error', '')[:200]}",
              flush=True)
    return failed


if __name__ == "__main__":
    main()
