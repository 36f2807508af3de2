#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--shards 1024] [--tokens-per-shard 262000]
                          [--target-mib 512] [--selectivity 0.05] [--seed 0]
                          [--model-batch 16]

Needs one CUDA card and ``nvcc``. Phases, each reported on its own lines:

1. the card: ``nvidia-smi`` name and power limit, and torch's device name;
2. build: every kernel under ``src/repro_torch/kernels/csrc`` (setup time),
   with the registers and spills of each ``flash_attn``, ``decode_attn``
   and ``compact_pack`` instantiation from ``ptxas -v``, and each
   ``flash_attn`` kernel's ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load)
   counts from ``cuobjdump -sass``, both required in every bf16
   instantiation;
3. each kernel against its plain PyTorch version on the card: both
   ``compact_pack`` kernels bit for bit (``torch.equal`` on the bits) over
   the plan x ``block_chunks`` grid, the keep fractions of the fused filter,
   three dtypes and one full-size bin; ``rmsnorm``, ``decode_attn``,
   ``paged_attn`` and ``flash_attn`` within their registry ``tol`` and
   within ``ROW_REL_BAR`` (each output row against its own scale) over
   GQA groups 1/2/4 (and 8 for decode), head_dim 64/128, bf16 and f32,
   causal / windowed / non-causal masks, ragged lengths (0 included), one
   row of length S at B 1, a batch of lengths <= 0, lengths block_k - 1,
   block_k and block_k + 1, flash at S 1024, 1000 and 77 over two
   sequences, and every clamped
   candidate of each axis, exact axes bit-equal across their candidates,
   and a planted fault in each attention kernel's inputs that the bar
   must reject;
4. the compaction path: one training-corpus table fed by CDC trickle
   ingest, one AutoComp cycle compacting it to Iceberg's default 512 MiB
   target file size, and one GDPR-style rewrite-delete through the
   retention queue -- checked against numpy at full size, with the
   ``compact_pack`` kernels' launch counts;
5. the ``compact_pack`` kernels timed at that path's own inputs with CUDA
   events, beside the bandwidth bound, the plain version and one PyTorch
   library call;
6. the registry sweep at the full width of Granite-3-8B
   (``src/repro/configs/granite_3_8b.py``: d_model 4096, 32 heads, 8 KV
   heads, head_dim 128): each op against its plain version and the planted
   faults, then the sweep path -- ``tune_op`` on the full-width operands,
   ``tune_registry`` on the card (one cache entry per op), a second
   ``tune_registry`` served from the cache with 0 evaluations,
   ``tuned_page_size`` reading the swept page -- with the kernels' launch
   counts; then each op again at its tuned point, at full width (decode
   also bit-equal across two calls) and on its sweep example cell, and each
   kernel timed at its tuned point beside its bound, its plain version and
   one PyTorch library call;
7. ``fleet/corpus``: AutoComp as a service over 16 training-corpus tables
   with ``setup_fleet``'s class mix, fed by five sim-hours of seeded ingest
   (``CorpusFleet``); the service ticks a ``FleetScheduler`` after each
   sim-hour under a budget of half the first pool's cost, merging on the
   card, with a GDPR-style delete submitted before the second tick. Per
   tick it prints the wall, the merge's stage split and the report, and
   the table skipped the most cycles with its queued shares' cost against
   the budget, and holds every file written against numpy; then the
   compacted table with the most tokens goes through ``DataPipeline`` on
   the card at ``train_4k``'s micro-batch, every batch against numpy;
8. ``fleet/storm-2k``: ``FleetSpec()``'s 2000 tables for 4 cycles under 12
   GBHr with retention, as ``benchmarks/bench_fleet.py``'s nightly run, on
   the host with the default merge (no kernel);
9. ``model/train``: the model's training math, which calls no kernel of
   the registry (the reference's model calls none of its Pallas kernels):
   one model per family at its ``smoke_config`` in f32, forward+backward on
   the card against the CPU (loss, metrics, every gradient leaf); then
   ``paper-lm-100m`` (``src/repro/configs/paper_lm_100m.py``) at full width
   in bf16, seq 4096, ``--model-batch`` rows: one forward+backward timed
   (median of 5 after a warm-up) with its tokens/s, peak memory, TFLOP/s
   and share of the bf16 peak, one more under ``torch.profiler`` for the
   device's idle share and time by operator, the loss at init against
   ln(vocab), every gradient leaf finite and nonzero, and the bf16 loss
   against f32 on the same weights at batch 1; then ``xlstm-125m`` at full
   width, batch 2 x 256, and its sLSTM ``autograd.Function`` against plain
   autograd on the card;
10. ``train/launch``: the trainer on the card. ``launch.train.main([])``
    at its own defaults (``paper-lm-100m`` at full width in bf16, 60 steps
    of 8 x 256 in 2 microbatches, an AutoComp cycle every 25 steps merging
    with ``compact_chunks``, a checkpoint every 20): the step ms and
    tokens/s, the checkpoint saves' blocking time and the cycles' time,
    every merge against numpy and every cycle's counts against a host
    replay (``device="cpu"``), and ``compact_chunks``'s launches on this
    path (``launches_by_path["train"]``); the same wiring preempted at step
    30, restored from the step-20 checkpoint onto the card and run to step
    60; then the train step at ``train_4k``'s width (``--model-batch`` x
    4096, one microbatch) from a ``Trainer`` over the launcher's corpus,
    both gradient transports, prefetching and plain, with the step's
    excess over phase 9's forward+backward, peak memory and the consumer's
    wait for each batch; and ``compressed_psum`` on the embedding's
    full-width leaf, card against CPU, bit for bit;
11. ``serve/...``: serving on the card, which calls no kernel of the
    registry (the reference's model calls none). Each decoding family's
    smoke model in f32 with TF32 off, card against CPU: prefill logits
    and the first decode step's from the same cache within the CPU
    tests' f32 bar, greedy tokens equal (or the CPU's top-2 margin at the
    first difference under the bar), ``hubert-xlarge`` through the encode
    step; the reference's bit-equal properties on the card (a ragged row
    equals a solo run, slots equal batch, an evicted request equals an
    uncontended run, paged equals unpaged). Then Granite-3-8B at full
    width in bf16 (``src/repro/configs/granite_3_8b.py``), weights from
    ``init_params`` drawn on the card: 8 requests of 512-2048 tokens from
    ``--seed`` in a 2048-token buffer, 64 new tokens greedy, through the
    batch path in bf16, int8 and f8 storage, 4 slots under both cache
    transfers, and the fan-in engine (2 workers, 4 slots, 2 priority
    classes, priority eviction) unpaged and paged at the page phase 6's
    sweep left; per mode the end-to-end seconds, prefill ms and time to
    the first token, the decode step's median ms and tokens/s, peak GiB,
    the cache's bytes as stored, the engines' stats and one profiled
    decode step (idle share, device ms by kernel family); gated: logits
    finite, tokens in the vocabulary, paged tokens equal to unpaged, the
    int8 and f8 first-step logits within the reference's bars of bf16,
    the cache sizes, each ragged row's prefill within ``ROW_REL_BAR`` of
    a solo prefill, evictions in the contended fan-in; then ``cast_f8``
    over all 65,536 bf16 patterns, card against CPU, byte for byte;
12. ``train/ranks``: training across 4 ranks, spawned once, over NCCL
    when there is a card for each and otherwise over gloo with every rank
    on cuda:0 (printed, with the functional collectives staged through
    the host). (a) the two-stage int8 psum on paper-lm-100m's largest
    gradient leaf, each rank bit for bit against the one-process
    emulation; (b) the data-parallel step, paper-lm-100m at full width,
    8 x 4096 (2 rows a rank), 5 steps a transport: per-rank step ms, wire
    bytes by collective (int8_ef fewer than bf16), the loss against the
    one-process step within phase 9's bf16 bar; (c) the SPMD step under
    ``baseline`` on (data 2, model 2), Granite-3-8B at full width cut to 4
    of 40 layers at 2 x 2048: local shard shapes against
    ``resolve_spec``'s, step ms, the loss against one process; (d) the
    launcher's wiring across the ranks, cut to 6 steps with a cycle every
    3 and a checkpoint every 2: every merge against numpy,
    ``compact_chunks``'s launches (``train@4``), the losses against one
    process, the last checkpoint restored with ``shardings=`` bit for
    bit, and steps 4-5 again from the step-4 checkpoint against the first
    run; then one NCCL rank at world 1 on a (1, 1) ``DeviceMesh``: the
    parameters laid out and gathered back, the data-parallel step under
    ``int8_ef``.
13. ``serve/ranks``: serving across the same ranks (``SERVE_RANKS_PLAN``).
14. ``dryrun/...``: the dry-run analysis (``launch/dryrun.py``) in a
    subprocess, since its fake process group of 256 ranks cannot share a
    process with phases 12-13's group: fake tensors on the card, the
    ``(16, 16)`` mesh; ``paper-lm-100m`` ``train_4k`` under both gradient
    transports, ``granite-3-8b`` ``decode_32k`` under ``serve_sp`` in
    both activation transports (with the ``disagg`` and ``fanin``
    blocks), ``qwen3-moe-30b-a3b`` ``decode_32k`` under ``ep`` (the
    ``expert_a2a`` wire of its int8 program) and ``hubert-xlarge``
    ``decode_32k``, which must come back ``skip``. Per cell its roofline
    terms and its wall seconds on the host; gated: every cell ``ok`` (or
    the skip), and the int8 act-gather wire below bf16's over 1.5.

Times are CUDA events around each call, the host's work up to the launch
included, as a user of the op pays it. Each kernel's entry also carries
``device_ms`` (and ``library_device_ms``): the same call behind a queued
spin kernel, so that the events time the device alone.

The tuned-point cache lives in a fresh temporary directory for the run
(``REPRO_TORCH_TUNED_DIR``), so no earlier sweep changes a default point.
The kernels line's ``launches`` for the ``compact_pack`` kernels is the
sum over phases 4 and 7 (and 10 and 12 for ``compact_chunks``),
``launches_by_path`` each; every kernel's ``launches_by_path["serve"]``
is phase 11's count, 0. It exits non-zero when
a phase fails, and prints as its last line
``{"ok": true, "device": {...}}`` only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import importlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import core as port_core  # noqa: E402
from repro_torch import data as port_data  # noqa: E402
from repro_torch import lst as port_lst  # noqa: E402
from repro_torch.core import (AutoCompPipeline, ComputeCostTrait,  # noqa: E402
                              FileCountReductionTrait, FileEntropyTrait,
                              MoopRanker, RetentionQueue, Scope,
                              StatsCollector, TraitContext)
from repro_torch.core import act as port_act  # noqa: E402
from repro_torch.core import fleet as port_fleet  # noqa: E402
from repro_torch.core import service as port_service  # noqa: E402
from repro_torch.core.act import Scheduler  # noqa: E402
from repro_torch.data import packing  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.data.shards import (TokenShardWriter, decode_shard,  # noqa: E402
                                     decode_shard_padded)
from repro_torch.kernels import api, build, tune, tuned  # noqa: E402
from repro_torch.kernels.compact_pack import compact_pack as kern  # noqa: E402
from repro_torch.kernels.compact_pack import ops, ref  # noqa: E402
from repro_torch.lst import (Catalog, InMemoryStore,  # noqa: E402
                             PredicateDelete, plan_rewrite_delete)
from repro_torch.lst.compaction import plan_table  # noqa: E402
from repro_torch.lst import workload as port_workload  # noqa: E402
from repro_torch.lst.workload import SimClock  # noqa: E402
from repro_torch.kernels.paged_attn import tuned_page_size  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import registry as model_registry  # noqa: E402
from repro_torch.models import transformer as model_tf  # noqa: E402
from repro_torch.models import xlstm as model_xlstm  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.dist import collectives as coll  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402
from repro_torch.train.checkpoints import CheckpointManager  # noqa: E402
from repro_torch.train.runner import (RunnerConfig,  # noqa: E402
                                      SimulatedPreemption, Trainer)

MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA's data sheet
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores, the same
CHUNK_ROWS, CHUNK_COLS = kern.CHUNK_ROWS, kern.CHUNK_COLS
CHUNK_TOKENS = kern.CHUNK_TOKENS
SOURCE = "src/repro_torch/kernels/csrc/compact_pack.cu"
REPLACES = {
    "compact_chunks": "src/repro/kernels/compact_pack/compact_pack.py:58",
    "compact_filter": "src/repro/kernels/compact_pack/compact_pack.py:128",
    "rmsnorm": "src/repro/kernels/rmsnorm/rmsnorm.py:23",
    "decode_attn": "src/repro/kernels/decode_attn/decode_attn.py:77",
    "flash_attn": "src/repro/kernels/flash_attn/flash_attn.py:76",
}
# the sweep path's kernels: wrapper module (its LAUNCHES count) and source
SWEEP_KERNELS = {
    name: (importlib.import_module(f"repro_torch.kernels.{name}.{name}"),
           f"src/repro_torch/kernels/csrc/{name}.cu")
    for name in ("rmsnorm", "decode_attn", "flash_attn")}
# The sweep ops' on-card bar, beside the registry's absolute tol: each
# output row against its own scale. A long decode or causal row of
# unit-normal inputs has entries of about sqrt(e / length), under the 5e-2
# tol, so the tol alone would pass a kernel that dropped part of a row.
# Rounding to bf16 moves an entry by at most an ulp of the row's largest
# (2^-8 of it); f32 kernels agree to about 1e-6.
ROW_REL_BAR = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# Granite-3-8B (src/repro/configs/granite_3_8b.py)
GRANITE = {"d_model": 4096, "heads": 32, "kv_heads": 8, "head_dim": 128}
DEFAULTS = {"shards": 1024, "commits": 8, "tokens_per_shard": 262_000,
            "target_mib": 512, "selectivity": 0.05, "seed": 0,
            "model_batch": 16}
# fleet/corpus: 16 tables; five sim-hours, since a table reads as bursty
# only when its busiest hour holds 3x its mean hourly writes, which needs
# more than three whole hours of history; the one cut of scale: every
# stream's files per write times FLEET_FACTOR, so the fleet ingests
# 1.0-1.5 GiB of 1 MiB shards
FLEET_TABLES, FLEET_HOURS, FLEET_FACTOR = 16, 5, 0.3
# train_4k (src/repro/configs/shapes.py): seq 4096, global batch 256 over
# 8 microbatches
TRAIN_4K_SEQ, TRAIN_4K_MICROBATCH = 4096, 256 // 8
# fleet/storm-2k: bench_fleet.py's nightly run (--tables 2000 --cycles 4
# --budget 12 --retention)
STORM_CYCLES, STORM_BUDGET_GBHR = 4, 12.0
# model/train: one model per family at its smoke_config (f32, the card
# against the CPU, within tests/test_torch_models.py's f32 bars), then
# paper-lm-100m at full width in bf16 at train_4k's seq; the one cut of
# scale is the micro-batch, from train_4k's 32 (see PERF.md section 4)
MODEL_FAMILY_ARCHS = ("qwen3-moe-30b-a3b", "granite-3-8b", "minicpm3-4b",
                      "hymba-1.5b", "hubert-xlarge", "internvl2-2b",
                      "xlstm-125m")
MODEL_LOSS_TOL, MODEL_GRAD_TOL, MODEL_GRAD_FLOOR = 2e-6, 3e-5, 1e-6
MODEL_ARCH, MODEL_REPS = "paper-lm-100m", 5
XLSTM_BATCH, XLSTM_SEQ = 2, 256


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=DEFAULTS["shards"])
    ap.add_argument("--commits", type=int, default=DEFAULTS["commits"],
                    help="trickle_append commits the shards arrive in")
    ap.add_argument("--tokens-per-shard", type=int,
                    default=DEFAULTS["tokens_per_shard"])
    ap.add_argument("--target-mib", type=int, default=DEFAULTS["target_mib"],
                    help="compaction target file size (Iceberg's "
                         "write.target-file-size-bytes)")
    ap.add_argument("--selectivity", type=float,
                    default=DEFAULTS["selectivity"],
                    help="fraction of 128-token rows the delete matches")
    ap.add_argument("--seed", type=int, default=DEFAULTS["seed"])
    ap.add_argument("--model-batch", type=int,
                    default=DEFAULTS["model_batch"],
                    help="paper-lm-100m's micro-batch at seq 4096 in "
                         "phase 9 (train_4k's is 32)")
    ap.add_argument("--reps", type=int, default=25,
                    help="timed launches per kernel (median reported)")
    args = ap.parse_args()
    if args.shards % args.commits:
        ap.error("--shards must be a multiple of --commits")
    return args


# ---------------------------------------------------------------- helpers
def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits as a same-width integer tensor."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()])


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(bits(a), bits(b))


def random_payload(n_tokens: int, dtype: torch.dtype, dev, gen) -> torch.Tensor:
    """Random bits of ``dtype``, with some -0.0 for the float types."""
    width = torch.empty((), dtype=dtype).element_size()
    ints = {2: torch.int16, 4: torch.int32}[width]
    lo, hi = (-(1 << 15), 1 << 15) if width == 2 else (-(1 << 31), 1 << 31)
    raw = torch.randint(lo, hi, (n_tokens,), dtype=torch.int64,
                        generator=gen, device="cpu").to(ints).to(dev)
    if dtype.is_floating_point:
        raw[::7] = -(1 << (8 * width - 1))          # the bits of -0.0
    return raw.view(dtype)


# With ``device_only``, a spin kernel of this many cycles (~0.25 ms) runs
# before each timed launch, so the host's work for the launch overlaps it
# and the events time the device alone.
PREROLL_CYCLES = 500_000


def time_ms(fn, reps: int, warmup: int = 3,
            device_only: bool = False) -> float:
    """Median time of ``fn`` over ``reps`` runs, by CUDA events around the
    call: the host's work up to the launch included (the ``ms`` of every
    kernels line), or with ``device_only`` the device's time alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(PREROLL_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((bits(a).long() - bits(b).long()).abs().max().item())


def row_hash(rows: np.ndarray) -> np.ndarray:
    """64-bit FNV-1a over each row's whole content, then a splitmix64
    finaliser: a deterministic hash of every 128-token row."""
    words = np.ascontiguousarray(rows, dtype=np.int32).view(np.uint64)
    h = np.full(words.shape[0], 0xCBF29CE484222325, np.uint64)
    prime = np.uint64(0x100000001B3)
    for j in range(words.shape[1]):
        h ^= words[:, j]
        h *= prime
    h ^= h >> np.uint64(30)
    h *= np.uint64(0xBF58476D1CE4E5B9)
    h ^= h >> np.uint64(27)
    h *= np.uint64(0x94D049BB133111EB)
    h ^= h >> np.uint64(31)
    return h


def gdpr_rows(selectivity: float):
    """Row predicate of the delete: a row matches when the top 32 bits of
    its content hash fall below ``selectivity`` of their range."""
    cut = np.uint64(int(round(selectivity * (1 << 32))))

    def drop(rows, task=None):
        return (row_hash(rows) >> np.uint64(32)) < cut
    return drop


# ---------------------------------------------------------------- phases
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(f"nvidia-smi: {smi[0]}")
    name = torch.cuda.get_device_name(0)
    print(f"torch: {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    return smi[0], name


PTXAS_KERNELS = ("flash_attn", "decode_attn", "compact_pack")


def phase_build():
    """Every kernel, one ``nvcc`` per source, all at once; beside them a
    second compile of ``flash_attn.cu``, ``decode_attn.cu`` and
    ``compact_pack.cu`` with ``-Xptxas -v`` for their registers and
    spills. Returns the libraries."""
    t0 = time.perf_counter()
    csrc = os.path.join(ROOT, "src/repro_torch/kernels/csrc")
    scratch = tempfile.mkdtemp(prefix="chip_smoke_ptxas_")
    procs = {name: subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(scratch, f"{name}_v.so"),
         os.path.join(csrc, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in PTXAS_KERNELS}
    logs = {}
    try:
        libs = build.build_all()
        for name, proc in procs.items():
            logs[name] = proc.communicate(timeout=900)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(scratch, ignore_errors=True)
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for name, proc in procs.items():
        assert proc.returncode == 0, logs[name]
        print_ptxas(name, logs[name])
    print_sass_counts(str(libs["flash_attn"]))
    return libs


def demangle(names):
    tool = shutil.which("c++filt")
    if not tool or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def print_ptxas(kernel: str, log: str) -> None:
    """Each instantiation's registers and spills as ``ptxas -v`` reports
    them (the shared memory is dynamic, the launch plan's), and any
    warning or numbered performance note."""
    rows, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            rows.append([fn, "", ""])
        elif fn and "Used" in line and "registers" in line:
            rows[-1][1] = line.split(":", 1)[1].strip()
        elif fn and "spill" in line:
            rows[-1][2] = line.split(":")[-1].strip()
        elif re.search(r"warning|\(C\d{4}\)", line):
            # e.g. C7513: ptxas serialised every wgmma of a kernel
            print(f"ptxas {kernel}: {line.strip()}")
    names = demangle([r[0] for r in rows])
    for name, (_, used, spill) in zip(names, rows):
        print(f"ptxas {kernel} {name}: {used}; {spill}")
    assert rows, "ptxas -v printed no entry function"


def print_sass_counts(lib: str) -> None:
    """HGMMA (wgmma) and UTMALDG (TMA load) instructions per kernel of
    ``libflash_attn.so``, by ``cuobjdump -sass``; both must be in every
    bf16 kernel."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        print("sass flash_attn: cuobjdump not available")
        return
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"HGMMA": 0, "UTMALDG": 0}
        elif fn:
            for op in ("HGMMA", "UTMALDG"):
                counts[fn][op] += len(re.findall(rf"\b{op}\b", line))
    names = demangle(list(counts))
    bf16 = 0
    for name, c in zip(names, counts.values()):
        print(f"sass flash_attn {name}: HGMMA {c['HGMMA']}, UTMALDG "
              f"{c['UTMALDG']}")
        if "flash_bf16_kernel" in name:
            bf16 += 1
            assert c["HGMMA"] > 0 and c["UTMALDG"] > 0, (name, c)
    assert bf16 == 6, f"{bf16} bf16 kernels in the SASS, want 6"


def phase_parity(dev):
    gen = torch.Generator().manual_seed(1234)
    # dirty the allocator's free blocks so uninitialised outputs hold junk
    torch.full((64 * MIB,), -1, dtype=torch.int32, device=dev)
    plans = [([4, 4, 4, 4], [3, 1, 2, 0]), ([2, 6, 8], None),
             ([3, 1, 2], [2, 0, 1]), ([16, 16], None),
             ([16, 16, 16, 16], [3, 2, 1, 0])]
    n_checks = 0
    for dtype in (torch.int32, torch.bfloat16, torch.float32):
        for counts, order in plans:
            cm = ops.plan_compaction(counts, fragment_order=order)
            src = random_payload(sum(counts) * CHUNK_TOKENS, dtype, dev, gen)
            src3 = src.view(-1, CHUNK_ROWS, CHUNK_COLS)
            want = ref.compact_chunks_ref(
                src3, torch.from_numpy(cm).to(dev)).reshape(-1)
            for g in ops.BLOCK_CHUNKS_CANDIDATES:
                got = ops.compact_chunks(src, cm, block_chunks=g)
                assert same_bits(got, want), ("compact_chunks", dtype,
                                              counts, order, g)
                n_checks += 1
            rng = np.random.RandomState(len(counts) * 17 + n_checks)
            for frac in (0.0, 0.3, 1.0):
                keep = rng.rand(len(cm) * CHUNK_ROWS) >= frac
                got = ops.compact_chunks(src, cm, keep_mask=keep)
                want_f = ref.compact_filter_ref(
                    src3, torch.from_numpy(cm).to(dev), keep).reshape(-1)
                assert same_bits(got, want_f), ("compact_filter", dtype,
                                                counts, order, frac)
                n_checks += 1
        # the flush step: two chunks keep 5 rows each
        src = random_payload(2 * CHUNK_TOKENS, dtype, dev, gen)
        cm = np.arange(2, dtype=np.int32)
        keep = np.tile([True] * 5 + [False] * 3, 2)
        assert ops.plan_filter(cm, keep)[0].shape[0] == 3
        got = ops.compact_chunks(src, cm, keep_mask=keep)
        want = ref.compact_filter_ref(src.view(-1, CHUNK_ROWS, CHUNK_COLS),
                                      torch.from_numpy(cm).to(dev), keep)
        assert same_bits(got, want.reshape(-1)), ("flush", dtype)
        n_checks += 1
    print(f"parity: {n_checks} small cases bit-equal to the plain versions "
          f"(int32, bfloat16, float32; block_chunks "
          f"{list(ops.BLOCK_CHUNKS_CANDIDATES)}; keep fractions 0, 0.3, 1; "
          f"flush step)")


def phase_parity_full_bin(dev, n_chunks: int, selectivity: float):
    """One bin of the main path's size, random content, random order."""
    gen = torch.Generator().manual_seed(99)
    src = random_payload(n_chunks * CHUNK_TOKENS, torch.int32, dev, gen)
    src3 = src.view(-1, CHUNK_ROWS, CHUNK_COLS)
    rng = np.random.RandomState(5)
    cm = rng.permutation(n_chunks).astype(np.int32)
    cm_t = torch.from_numpy(cm).to(dev)
    got = ops.compact_chunks(src, cm)
    assert same_bits(got, ref.compact_chunks_ref(src3, cm_t).reshape(-1))
    keep = rng.rand(n_chunks * CHUNK_ROWS) >= selectivity
    got = ops.compact_chunks(src, cm, keep_mask=keep)
    want = ref.compact_filter_ref(src3, cm_t, keep).reshape(-1)
    assert same_bits(got, want)
    print(f"parity: full-size bin of {n_chunks} chunks "
          f"({n_chunks * CHUNK_TOKENS * 4 / MIB} MiB int32), permuted, "
          f"gather and filter bit-equal to the plain versions")


def bin_chunks(args) -> int:
    """Chunks in one full compaction bin of the deployment's shards."""
    shard_chunks = -(-args.tokens_per_shard // CHUNK_TOKENS)
    shard_bytes = 12 + 4 * CHUNK_TOKENS * shard_chunks   # header + payload
    per_bin = (args.target_mib * MIB) // shard_bytes
    return max(1, min(per_bin, args.shards)) * shard_chunks


class Recorder:
    """Keeps the largest inputs the merge hands ``compact_chunks``, for
    each kernel, so phase 5 times the kernels on the main path's own data.
    It records arguments only; the launches stay the wrapper's."""

    def __init__(self):
        self.largest = {}
        self._inner = packing.compact_chunks

    def __call__(self, src_tokens, chunk_map, **kw):
        name = "compact_filter" if kw.get("keep_mask") is not None \
            else "compact_chunks"
        prev = self.largest.get(name)
        if prev is None or src_tokens.numel() > prev[0].numel():
            self.largest[name] = (src_tokens, np.array(chunk_map),
                                  kw.get("keep_mask"))
        return self._inner(src_tokens, chunk_map, **kw)


def build_autocomp(target_bytes: int, merge_fn,
                   top_k: int = 4) -> AutoCompPipeline:
    """The cycle as ``launch/train.py::build_autocomp`` wires it."""
    return AutoCompPipeline(
        stats=StatsCollector(target_bytes),
        traits=(FileCountReductionTrait(), FileEntropyTrait(),
                ComputeCostTrait()),
        trait_ctx=TraitContext(target_file_bytes=target_bytes),
        ranker=MoopRanker({"file_count_reduction": 0.7, "compute_cost": 0.3}),
        scheduler=Scheduler(target_bytes, merge_fn=merge_fn),
        scope=Scope.TABLE, top_k=top_k)


def print_split(label: str, wall: float) -> None:
    split = dict(packing.STAGE_SECONDS)
    split["outside_merge"] = wall - sum(packing.STAGE_SECONDS.values())
    print(f"{label}: wall {wall} s; split (s) {json.dumps(split)}")


def output_for(table, task_id: int):
    hits = [f for f in table.current_files()
            if f.path.endswith(f"-{task_id}.toks")]
    assert len(hits) == 1, (task_id, [f.path for f in hits])
    return hits[0]


def phase_main_path(args, dev):
    target = args.target_mib * MIB
    merge_fn = functools.partial(packing.merge_shards_fn, device=dev)
    t0 = time.perf_counter()
    clock = SimClock()
    store = InMemoryStore()
    cat = Catalog(store, now_fn=clock.now)
    table = cat.create_table("train", "corpus",
                             properties={"conflict_granularity": "table"})
    table.now_fn = clock.now
    writer = TokenShardWriter(table, vocab=32000, seed=args.seed)
    for _ in range(args.commits):
        writer.trickle_append(args.shards // args.commits,
                              args.tokens_per_shard)
        clock.advance(0.02)
    files = table.current_files()
    table_bytes = sum(f.size_bytes for f in files)
    print(f"table: {table.table_id} {len(files)} shards in {args.commits} "
          f"commits, {files[0].size_bytes} bytes each, {table_bytes} bytes "
          f"({table_bytes / (1 << 30)} GiB); written in "
          f"{time.perf_counter() - t0} s")

    # ---- one AutoComp cycle
    plan = plan_table(table, target)
    before = {f.path: store.get(f.path) for f in files}
    print(f"cycle plan: {len(plan)} bins of "
          f"{[len(t.inputs) for t in plan]} shards at target {target} bytes")
    recorder = Recorder()
    packing.compact_chunks = recorder
    kern.reset_launches()
    packing.reset_stage_seconds()
    t0 = time.perf_counter()
    report = build_autocomp(target, merge_fn).run_cycle(cat)
    sync(dev)
    wall = time.perf_counter() - t0
    launches_cycle = dict(kern.LAUNCHES)
    print(f"cycle: files {len(files)} -> {len(table.current_files())}, "
          f"files_removed {report.files_removed}, gbhr {report.gbhr}, "
          f"launches {json.dumps(launches_cycle)}")
    print_split("cycle time", wall)
    assert len(table.current_files()) == len(plan)
    assert report.files_removed == len(files)
    for task in plan:
        got = decode_shard(store.get(output_for(table, task.task_id).path))
        want = np.concatenate([decode_shard(before[f.path])
                               for f in task.inputs])
        assert np.array_equal(got, want), task.task_id
    del before
    print("cycle check: every output shard holds exactly its inputs' true "
          "tokens, in order")

    # ---- one GDPR-style rewrite-delete through the retention queue
    clock.advance(1.0)
    drop_rows = gdpr_rows(args.selectivity)
    queue = RetentionQueue(target_file_bytes=target)
    queue.submit(PredicateDelete("gdpr-purge", row_predicate=drop_rows,
                                 est_selectivity=args.selectivity,
                                 tables=(table.table_id,)))
    cands = queue.propose([table])
    assert len(cands) == 1
    tasks = plan_rewrite_delete(table, cands[0].delete_route.rewrite_files,
                                target)
    before = {f.path: store.get(f.path) for f in table.current_files()}
    print(f"delete plan: {len(tasks)} rewrite bins of "
          f"{[len(t.inputs) for t in tasks]} files")
    kern.reset_launches()
    packing.reset_stage_seconds()
    t0 = time.perf_counter()
    act = Scheduler(target, merge_fn=merge_fn).execute(cands)
    for c in cands:
        queue.note_executed(c)
    sync(dev)
    wall = time.perf_counter() - t0
    launches_delete = dict(kern.LAUNCHES)
    packing.compact_chunks = recorder._inner
    assert not queue.has_pending() and act.failures == 0

    want_dropped = valid_rows = 0
    for task in tasks:
        want, dropped, valid = rows_after_delete(
            [(f, before[f.path]) for f in task.inputs], drop_rows)
        got = decode_shard(store.get(output_for(table, task.task_id).path))
        assert np.array_equal(got, want), task.task_id
        want_dropped += dropped
        valid_rows += valid
    print(f"delete: files {len(before)} -> {len(table.current_files())}, "
          f"rows_dropped {act.rows_dropped} of {valid_rows} content rows "
          f"(selectivity {act.rows_dropped / valid_rows}, asked "
          f"{args.selectivity}), gbhr {act.gbhr}, "
          f"launches {json.dumps(launches_delete)}")
    print_split("delete time", wall)
    assert act.rows_dropped == want_dropped, (act.rows_dropped, want_dropped)
    print("delete check: every output holds exactly the rows numpy's "
          "keep & valid selects; rows_dropped equals numpy's count")
    launches = {k: launches_cycle[k] + launches_delete[k]
                for k in kern.LAUNCHES}
    assert all(n > 0 for n in launches.values()), launches
    return launches, recorder.largest


def phase_times(args, dev, launches, largest):
    reps = args.reps
    results = []

    # compact_chunks at the largest bin of the cycle, at the point the main
    # path resolved (default block_chunks unless a tuned point exists)
    src, cm, _ = largest["compact_chunks"]
    src3 = src.view(-1, CHUNK_ROWS, CHUNK_COLS)
    op = api.get_op("compact_pack")
    point = op.clamp(api.resolve_point(op, src, cm), src, cm)
    g, cmg = ops.coarsen_plan(cm, src3.shape[0], point["block_chunks"])
    srcg = src3.view(-1, g * CHUNK_ROWS, CHUNK_COLS)
    cmg_t = torch.from_numpy(cmg).to(dev)
    cm_t = torch.from_numpy(cm).to(dev)
    cm_long = cm_t.long()
    got = kern.compact_chunks_kernel(srcg, cmg_t).reshape(-1)
    want = ref.compact_chunks_ref(src3, cm_t).reshape(-1)
    assert same_bits(got, want)
    err = max_abs_err(got, want)
    del got, want
    block_bytes = srcg[0].numel() * srcg.element_size()
    n_bytes = 2 * cmg.shape[0] * block_bytes + 4 * cmg.shape[0]
    plain_ms = time_ms(lambda: ref.compact_chunks_ref(src3, cm_t), reps)
    ms = time_ms(lambda: kern.compact_chunks_kernel(srcg, cmg_t), reps)
    lib_ms = time_ms(lambda: torch.index_select(src3, 0, cm_long), reps)
    dev_ms = time_ms(lambda: kern.compact_chunks_kernel(srcg, cmg_t), reps,
                     device_only=True)
    lib_dev_ms = time_ms(lambda: torch.index_select(src3, 0, cm_long), reps,
                         device_only=True)
    results.append(dict(
        name="compact_chunks", route="cuda", source=SOURCE,
        replaces=REPLACES["compact_chunks"],
        launches=launches["compact_chunks"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=1e3 * n_bytes / HBM_BYTES_PER_S,
        bound_by="bytes", library_ms=lib_ms, device_ms=dev_ms,
        library_device_ms=lib_dev_ms))
    print(f"compact_chunks: {cm.shape[0]} chunks, block_chunks {g}, "
          f"{n_bytes} bytes moved; kernel {ms} ms (device {dev_ms} ms, "
          f"{n_bytes / dev_ms / 1e6} GB/s), plain {plain_ms} ms, "
          f"index_select {lib_ms} ms (device {lib_dev_ms} ms), bound "
          f"{results[-1]['bound_ms']} ms")
    sweep = {}
    for gg in ops.BLOCK_CHUNKS_CANDIDATES:
        g2, cm2 = ops.coarsen_plan(cm, src3.shape[0], gg)
        s2 = src3.view(-1, g2 * CHUNK_ROWS, CHUNK_COLS)
        c2 = torch.from_numpy(cm2).to(dev)
        sweep[f"g{g2}"] = time_ms(lambda: kern.compact_chunks_kernel(s2, c2),
                                  reps)
    print(f"compact_chunks block_chunks sweep (ms): {json.dumps(sweep)}")
    del src, src3, srcg

    # compact_filter at the largest bin of the delete
    src, cm, keep = largest["compact_filter"]
    src3 = src.view(-1, CHUNK_ROWS, CHUNK_COLS)
    chunk_sel, dest, _, out_idx, n_out = ops.plan_filter(cm, keep)
    n_kept = int(np.count_nonzero(dest != kern.DROP_SLOT))
    tables = [torch.from_numpy(a).to(dev) for a in (chunk_sel, dest, out_idx)]
    cm_t = torch.from_numpy(cm).to(dev)
    kept_rows = torch.from_numpy(np.flatnonzero(
        np.asarray(keep).reshape(-1))).to(dev)
    rows = src3.view(-1, CHUNK_COLS)
    got = kern.compact_filter_kernel(src3, *tables, n_out, n_kept)
    want = ref.compact_filter_ref(src3, cm_t, keep)
    assert same_bits(got, want)
    err = max_abs_err(got, want)
    del got, want
    row_bytes = CHUNK_COLS * src.element_size()
    n_bytes = (n_kept + n_out * CHUNK_ROWS) * row_bytes \
        + 4 * (2 * chunk_sel.shape[0] + dest.shape[0])
    plain_ms = time_ms(lambda: ref.compact_filter_ref(src3, cm_t, keep), reps)
    ms = time_ms(lambda: kern.compact_filter_kernel(src3, *tables, n_out,
                                                     n_kept), reps)
    dev_ms = time_ms(lambda: kern.compact_filter_kernel(
        src3, *tables, n_out, n_kept), reps, device_only=True)
    # the identity plan: kept rows of the packed stream are rows of src
    assert np.array_equal(cm, np.arange(cm.shape[0]))
    lib_ms = time_ms(lambda: torch.index_select(rows, 0, kept_rows), reps)
    lib_dev_ms = time_ms(lambda: torch.index_select(rows, 0, kept_rows), reps,
                         device_only=True)
    results.append(dict(
        name="compact_filter", route="cuda", source=SOURCE,
        replaces=REPLACES["compact_filter"],
        launches=launches["compact_filter"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=1e3 * n_bytes / HBM_BYTES_PER_S,
        bound_by="bytes", library_ms=lib_ms, device_ms=dev_ms,
        library_device_ms=lib_dev_ms))
    print(f"compact_filter: {cm.shape[0]} chunks, {n_kept} of "
          f"{keep.size} rows kept, {n_out} output chunks, {n_bytes} bytes "
          f"moved; kernel {ms} ms (device {dev_ms} ms, "
          f"{n_bytes / dev_ms / 1e6} GB/s), plain {plain_ms} ms, index_select "
          f"of kept rows {lib_ms} ms (device {lib_dev_ms} ms), bound "
          f"{results[-1]['bound_ms']} ms")
    return results


# ---------------------------------------------------------------- the sweep
def float_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.float() - b.float()).abs().max().item())


def row_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Each output row (the last axis) against its own scale: the largest
    ``max|a - b| / max|b|`` over the rows."""
    if a.numel() == 0:
        return 0.0
    a, b = a.float(), b.float()
    scale = b.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    return float(((a - b).abs().amax(-1) / scale).max().item())


def check_close(op, got, want, *what) -> tuple:
    """The kernel's output within the op's registry ``tol`` and within
    ``ROW_REL_BAR`` of its dtype; returns (max abs err, max row err)."""
    err, rel = float_err(got, want), row_rel_err(got, want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (op.name, what, got.dtype, want.dtype, got.shape, want.shape)
    assert err <= op.tol and rel <= ROW_REL_BAR[got.dtype], \
        (op.name, what, err, rel)
    return err, rel


def planted_fault(name: str, a, kw) -> torch.Tensor:
    """The kernel run with a fault a wrong kernel could have: decode drops
    the last 64 live positions of every row longer than 64 (a lost final
    tile or split); flash drops up to the 64 oldest keys of the last 64
    query rows (a window of S - 64)."""
    if name == "decode_attn":
        q, k, v, lens = a
        return api.call(name, q, k, v, torch.where(lens > 64, lens - 64,
                                                   lens))
    q, k, v = a
    return api.call(name, q, k, v, **{**kw, "window": q.shape[2] - 64})


def assert_fault_rejected(name: str, a, kw) -> tuple:
    """The planted fault must fail ``ROW_REL_BAR``; returns its (max abs
    err, max row err) against the plain version."""
    bad = planted_fault(name, a, kw)
    want = api.get_op(name).ref(*a, **kw)
    err, rel = float_err(bad, want), row_rel_err(bad, want)
    assert rel > ROW_REL_BAR[bad.dtype], ("planted fault passed", name,
                                          str(bad.dtype), err, rel)
    return err, rel


def reset_sweep_launches() -> None:
    for mod, _ in SWEEP_KERNELS.values():
        mod.reset_launches()


def sweep_launches() -> dict:
    return {name: mod.LAUNCHES[name]
            for name, (mod, _) in SWEEP_KERNELS.items()}


DECODE_LENS = (0, 1, 333, 1000, 1024)


def decode_cases(randn, dtype, d, dev):
    """The decode grid: (label, q, k, v, lengths, block_k or None for
    every clamped candidate). GQA groups 1/2/4/8 over five ragged rows at
    S 1024 (a lengths == 0 row among them); one row of length S = 8192 at
    B 1, spread over the CTAs; a batch whose lengths are all <= 0; and at
    each block_k candidate, rows of block_k - 1, block_k and block_k + 1
    positions."""
    def lengths(*ns):
        return torch.tensor(ns, dtype=torch.int32, device=dev)

    def kv(b, s, hkv):
        return randn((b, s, hkv, d), dtype), randn((b, s, hkv, d), dtype)

    s = 1024
    for group in (1, 2, 4, 8):
        q = randn((len(DECODE_LENS), 2 * group, d), dtype)
        yield (f"G{group}", q, *kv(len(DECODE_LENS), s, 2),
               lengths(*DECODE_LENS), None)
    yield ("B1 one row of S 8192", randn((1, 4, d), dtype), *kv(1, 8192, 1),
           lengths(8192), None)
    yield ("lengths all <= 0", randn((3, 4, d), dtype), *kv(3, 512, 2),
           lengths(0, -5, 0), None)
    q, k, v = randn((3, 8, d), dtype), *kv(3, 2048, 2)
    for bk in api.get_op("decode_attn").axes["block_k"]:
        yield (f"block_k {bk} +-1", q, k, v, lengths(bk - 1, bk, bk + 1), bk)


def phase_parity_sweep_ops(dev):
    """The sweep's three kernels against their plain versions on a small
    grid, over every clamped candidate of each axis; exact axes bit-equal
    across their candidates, ``paged_attn`` bit-equal to ``decode_attn`` at
    every page."""
    gen = torch.Generator().manual_seed(4321)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)

    worst = {"rmsnorm": 0.0, "decode_attn": 0.0, "flash_attn": 0.0}
    worst_rel = {f"{n} {str(dt)[6:]}": 0.0 for n in worst
                 for dt in (torch.bfloat16, torch.float32)}
    faults = {}
    zero_row = 0.0
    rel_f32 = [0.0, 0.0, 0.0]
    n_checks = 0
    dtypes = (torch.bfloat16, torch.float32)

    op = api.get_op("rmsnorm")
    for dtype in dtypes:
        for r, d in ((1024, 64), (640, 128), (256, 4096), (96, 8192)):
            x, sc = randn((r, d), dtype), randn((d,), dtype)
            want = op.ref(x, sc)
            outs = []
            for br in api.clamped_axes(op, x, sc)["block_rows"]:
                got = op.run({"block_rows": br}, x, sc)
                err, rel = check_close(op, got, want, dtype, r, d, br)
                worst["rmsnorm"] = max(worst["rmsnorm"], err)
                key = f"rmsnorm {str(dtype)[6:]}"
                worst_rel[key] = max(worst_rel[key], rel)
                outs.append(got)
                n_checks += 1
            assert all(same_bits(o, outs[0]) for o in outs), \
                ("rmsnorm block_rows not exact", dtype, r, d)

    op, pop = api.get_op("decode_attn"), api.get_op("paged_attn")
    for dtype in dtypes:
        for d in (64, 128):
            for label, q, k, v, lens, bk in decode_cases(randn, dtype, d, dev):
                want = op.ref(q, k, v, lens)
                cands = [bk] if bk else \
                    api.clamped_axes(op, q, k, v, lens)["block_k"]
                for bk in cands:
                    got = op.run({"block_k": bk}, q, k, v, lens)
                    err, rel = check_close(op, got, want, dtype, d, label, bk)
                    worst["decode_attn"] = max(worst["decode_attn"], err)
                    key = f"decode_attn {str(dtype)[6:]}"
                    worst_rel[key] = max(worst_rel[key], rel)
                    if dtype == torch.bfloat16:
                        # both products in f32 on the FMA path: the f32
                        # kernel on the same (exactly upcast) inputs; and
                        # both paths against the f32 result before its
                        # rounding to bf16
                        up = (q.float(), k.float(), v.float(), lens)
                        via_f32 = op.run({"block_k": bk}, *up)
                        exact = op.ref(*up)
                        rel_f32[0] = max(rel_f32[0], row_rel_err(
                            via_f32.to(dtype), want))
                        rel_f32[1] = max(rel_f32[1],
                                         row_rel_err(got.float(), exact))
                        rel_f32[2] = max(rel_f32[2], row_rel_err(
                            via_f32.to(dtype).float(), exact))
                    zero = lens <= 0
                    if zero.any():
                        zero_row = max(zero_row,
                                       float_err(got[zero], want[zero]))
                    n_checks += 1
                if d == 128 and label == "G4":
                    faults[f"decode_attn {str(dtype)[6:]}"] = \
                        assert_fault_rejected("decode_attn",
                                              (q, k, v, lens), {})
                base = api.call("decode_attn", q, k, v, lens)
                for page in api.clamped_axes(pop, q, k, v, lens)["page"]:
                    got = pop.run({"page": page}, q, k, v, lens)
                    assert same_bits(got, base), ("paged_attn", dtype, d,
                                                  label, page)
                    n_checks += 1

    n_checks += phase_parity_flash(randn, worst, worst_rel, faults)
    print(f"parity: {n_checks} sweep-op cases (bfloat16, float32; head_dim "
          f"64, 128; GQA groups 1, 2, 4, and 8 for decode; causal, window 32 "
          f"and 128, non-causal; decode lengths {list(DECODE_LENS)}, one row "
          f"of 8192 at B 1, a batch of lengths 0, -5, 0, block_k - 1, "
          f"block_k and block_k + 1 at each block_k; flash at B 2 and S "
          f"{list(FLASH_SEQS)}; every clamped "
          f"candidate); max |kernel - plain| {json.dumps(worst)} within tol "
          f"(rmsnorm 0.1, attention 0.05); max row error (max |kernel - "
          f"plain| / max |plain| per output row) {json.dumps(worst_rel)} "
          f"within the bar (bfloat16 {ROW_REL_BAR[torch.bfloat16]}, float32 "
          f"{ROW_REL_BAR[torch.float32]}); lengths==0 rows {zero_row}; "
          f"rmsnorm block_rows and flash_attn block_q bit-equal across "
          f"candidates; paged_attn bit-equal to decode_attn at every page")
    print(f"parity: decode_attn bfloat16 max row error "
          f"{worst_rel['decode_attn bfloat16']} on mma.sync (p v with p as "
          f"hi + lo bfloat16), {rel_f32[0]} with both products in float32 "
          f"on the FMA path (the float32 kernel on the same inputs, its "
          f"output rounded to bfloat16); against the float32 result before "
          f"its rounding: mma.sync {rel_f32[1]}, FMA path {rel_f32[2]}")
    print(f"parity: planted faults (decode drops the last 64 live positions "
          f"of each row, flash the 64 oldest keys of the last 64 rows) "
          f"rejected by the row bar, (max abs err, max row error): "
          f"{json.dumps(faults)}")


FLASH_SEQS = (1024, 1000, 77)   # 1000 and 77: ragged tiles, no divisor
FLASH_MASKS = ((True, 0), (True, 32), (True, 128), (False, 0), (False, 32))


def phase_parity_flash(randn, worst, worst_rel, faults) -> int:
    """``flash_attn`` against its plain version at B = 2 (so the kernel
    crosses head and sequence boundaries) for S 1024, 1000 and 77, over
    every mask and every clamped candidate; ``block_q`` bit-exact, and the
    planted fault rejected at every S. Returns the number of checks."""
    op = api.get_op("flash_attn")
    n_checks = 0
    for s in FLASH_SEQS:
        for dtype in (torch.bfloat16, torch.float32):
            for d in (64, 128):
                for group in (1, 2, 4):
                    hkv = 2
                    q = randn((2, hkv * group, s, d), dtype)
                    k, v = randn((2, hkv, s, d), dtype), \
                        randn((2, hkv, s, d), dtype)
                    axes = api.clamped_axes(op, q, k, v)
                    for causal, window in FLASH_MASKS:
                        kw = {"causal": causal, "window": window}
                        want = op.ref(q, k, v, **kw)
                        for bk in axes["block_k"]:
                            outs = []
                            for bq in axes["block_q"]:
                                got = op.run({"block_q": bq, "block_k": bk},
                                             q, k, v, **kw)
                                err, rel = check_close(op, got, want, dtype,
                                                       s, d, group, kw, bq,
                                                       bk)
                                worst["flash_attn"] = max(
                                    worst["flash_attn"], err)
                                key = f"flash_attn {str(dtype)[6:]}"
                                worst_rel[key] = max(worst_rel[key], rel)
                                outs.append(got)
                                n_checks += 1
                            assert all(same_bits(o, outs[0]) for o in outs), \
                                ("flash_attn block_q not exact", dtype, s, d,
                                 group, kw, bk)
                    if d == 128 and group == 4:
                        faults[f"flash_attn {str(dtype)[6:]} S={s}"] = \
                            assert_fault_rejected(
                                "flash_attn", (q, k, v),
                                {"causal": True, "window": 0})
    return n_checks


def valid_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps in one (sequence, head)."""
    qp = np.arange(s, dtype=np.int64)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros_like(qp)
    hi = qp + 1 if causal else np.full_like(qp, s)
    return int((hi - lo).sum())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def full_width_cells(seed: int, dev):
    """Granite-3-8B's full-width operands, drawn from ``seed`` on the card:
    ``(args, kwargs, bytes, flops)`` per op, the counts being what this
    run's data needs (the rows below each length; the pairs the mask
    keeps)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16
    h, hkv, d = GRANITE["heads"], GRANITE["kv_heads"], GRANITE["head_dim"]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    cells = {}
    # 8 sequences x 4096 tokens of d_model; trained norm weights sit near 1
    x = randn(8 * 4096, GRANITE["d_model"])
    sc = (1 + 0.1 * torch.randn((GRANITE["d_model"],), generator=gen,
                                device=dev)).to(bf16)
    cells["rmsnorm"] = ((x, sc), {}, 2 * nbytes(x) + nbytes(sc),
                        3 * x.numel())
    # one sequence of prefill_8k, causal
    s = 8192
    q, k, v = randn(1, h, s, d), randn(1, hkv, s, d), randn(1, hkv, s, d)
    cells["flash_attn"] = ((q, k, v), {"causal": True},
                           2 * nbytes(q) + nbytes(k, v),
                           4 * h * d * valid_pairs(s, True, 0))
    # 8 sequences of decode_32k, lengths drawn in [1, 32768], one at 32768
    s = 32768
    rng = np.random.RandomState(seed)
    lens_np = rng.randint(1, s + 1, size=8)
    lens_np[rng.randint(8)] = s
    qd = randn(8, h, d)
    kd, vd = randn(8, s, hkv, d), randn(8, s, hkv, d)
    lens = torch.from_numpy(lens_np.astype(np.int32)).to(dev)
    live = int(np.minimum(lens_np, s).sum())
    dec_bytes = 2 * nbytes(qd) + nbytes(lens) + 2 * live * hkv * d * 2
    cells["decode_attn"] = ((qd, kd, vd, lens), {}, dec_bytes,
                            4 * h * d * live)
    cells["paged_attn"] = cells["decode_attn"]
    for name, (a, kw, nb, fl) in cells.items():
        shapes = ", ".join(f"{tuple(t.shape)} {str(t.dtype)[6:]}" for t in a)
        print(f"full width {name}: {shapes} {json.dumps(kw)}; "
              f"{nb} bytes, {fl} flops")
    print(f"full width decode lengths (seed {seed}): {lens_np.tolist()}")
    return cells


def phase_full_width_parity(cells, which: str):
    """Each op at full width through ``api.call`` against its plain
    version, at the point the call resolves: the default before the sweep
    (the cache is fresh), the tuned point after it. Returns the max abs
    errors."""
    errs, rels, points = {}, {}, {}
    for name, (a, kw, _, _) in cells.items():
        op = api.get_op(name)
        points[name] = op.clamp(api.resolve_point(op, *a, **kw), *a, **kw)
        got = api.call(name, *a, **kw)
        want = op.ref(*a, **kw)
        errs[name], rels[name] = check_close(op, got, want, which)
        if name == "paged_attn":
            assert same_bits(got, api.call("decode_attn", *a, **kw))
        if name == "decode_attn":
            # the combine is ordered: two calls give the same bits
            assert same_bits(got, api.call(name, *a, **kw)), which
        del got, want
    print(f"full width parity at the {which} points {json.dumps(points)}: "
          f"max |kernel - plain| {json.dumps(errs)} within tol; max row "
          f"error {json.dumps(rels)} within the bar; paged_attn bit-equal to "
          f"decode_attn; decode_attn bit-equal across two calls")
    return errs


def phase_full_width_faults(cells):
    """The planted faults at full width, rejected by the row bar."""
    faults = {name: assert_fault_rejected(name, *cells[name][:2])
              for name in ("decode_attn", "flash_attn")}
    print(f"full width planted faults rejected by the row bar, (max abs "
          f"err, max row error): {json.dumps(faults)}")


def phase_example_parity():
    """Each op on its sweep example cell (``example(quick=False)``) at the
    point the sweep cached for it, against its plain version."""
    errs, points = {}, {}
    for name, op in api.ops().items():
        a, kw = op.example(False)
        points[name] = op.clamp(api.resolve_point(op, *a, **kw), *a, **kw)
        got, want = op.run(points[name], *a, **kw), op.ref(*a, **kw)
        if op.tol == 0:
            assert same_bits(got, want), (name, points[name])
            errs[name] = (0.0, 0.0)
        else:
            errs[name] = check_close(op, got, want, "example", points[name])
    print(f"example cells at the swept points {json.dumps(points)}: (max "
          f"abs err, max row error) {json.dumps(errs)} within tol and the "
          f"row bar (compact_pack bit-equal)")


def phase_sweep_path(cells):
    """The slice's path: ``tune_op`` on the full-width operands, then the
    registry sweep on the card twice (the second from the cache), then the
    page size serving reads. Returns the launches and the winners."""
    reset_sweep_launches()
    winners = {}
    t0 = time.perf_counter()
    for name, (a, kw, _, _) in cells.items():
        out = tune.tune_op(name, args=a, kwargs=kw, force=True)
        winners[name] = out
        print(f"tune_op {name} {out.shape_key}: point {json.dumps(out.point)}"
              f" objective {out.objective_us} us, default "
              f"{json.dumps(out.default)}, {out.evaluations} evaluations; "
              f"wall us by point {json.dumps(out.history)}")
    sweep = tune.tune_registry(quick=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sweep_launches()
    kind = tuned.device_kind()
    for name, out in sweep.items():
        rec = tuned.entry(name, out.shape_key)
        assert rec is not None and rec["device_kind"] == kind, (name, rec)
        assert not out.cache_hit and out.evaluations > 0, name
        print(f"tune_registry {name} {out.shape_key}: point "
              f"{json.dumps(out.point)} objective {out.objective_us} us, "
              f"{out.evaluations} evaluations")
    assert set(sweep) == set(api.ops()), sorted(sweep)
    again = tune.tune_registry(quick=False)
    assert all(o.cache_hit and o.evaluations == 0 for o in again.values())
    page = tuned_page_size(2048, batch=4)
    assert page == sweep["paged_attn"].point["page"], page
    print(f"sweep path: {len(sweep)} ops swept under {kind!r}, second sweep "
          f"0 evaluations (all cache hits), tuned_page_size(2048, batch=4) "
          f"= {page}; wall {wall} s; launches {json.dumps(launches)}")
    assert all(n > 0 for n in launches.values()), launches
    return launches, winners


def library_call(name, a, kw):
    """One PyTorch call computing the same function: the yardstick only."""
    F = torch.nn.functional
    if name == "rmsnorm":
        x, sc = a
        return lambda: F.rms_norm(x, (x.shape[-1],), weight=sc, eps=1e-6)
    if name == "flash_attn":
        q, k, v = a
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
    q, k, v, lens = a
    s = k.shape[1]
    mask = (torch.arange(s, device=q.device)[None, :] < lens[:, None]
            )[:, None, None, :]
    qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)


def phase_full_width_times(cells, launches, errs, reps):
    """Each kernel at its tuned point, the default point, its plain version
    and its library call, by CUDA events."""
    results = []
    for name, (mod, source) in SWEEP_KERNELS.items():
        a, kw, nb, fl = cells[name]
        op = api.get_op(name)
        point = op.clamp(api.resolve_point(op, *a, **kw), *a, **kw)
        default = op.clamp(api.default_point(op), *a, **kw)
        ms = time_ms(lambda: op.run(point, *a, **kw), reps)
        default_ms = time_ms(lambda: op.run(default, *a, **kw), reps)
        plain_ms = time_ms(lambda: op.ref(*a, **kw), reps)
        lib_ms = time_ms(library_call(name, a, kw), reps)
        dev_ms = time_ms(lambda: op.run(point, *a, **kw), reps,
                         device_only=True)
        lib_dev_ms = time_ms(library_call(name, a, kw), reps,
                             device_only=True)
        t_bytes, t_ops = nb / HBM_BYTES_PER_S, fl / BF16_FLOPS_PER_S
        bound_ms = 1e3 * max(t_bytes, t_ops)
        results.append(dict(
            name=name, route="cuda", source=source,
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib_ms, device_ms=dev_ms,
            library_device_ms=lib_dev_ms))
        print(f"{name}: point {json.dumps(point)} {ms} ms (device {dev_ms} "
              f"ms), default {json.dumps(default)} {default_ms} ms; plain "
              f"{plain_ms} ms, library {lib_ms} ms (device {lib_dev_ms} ms), "
              f"bound {bound_ms} ms ({results[-1]['bound_by']}; device "
              f"{nb / dev_ms / 1e6} GB/s, {fl / dev_ms / 1e9} TFLOP/s)")
    a, kw, nb, _ = cells["paged_attn"]
    op = api.get_op("paged_attn")
    point = op.clamp(api.resolve_point(op, *a, **kw), *a, **kw)
    ms = time_ms(lambda: op.run(point, *a, **kw), reps)
    plain_ms = time_ms(lambda: op.ref(*a, **kw), reps)
    print(f"paged_attn: point {json.dumps(point)} {ms} ms (the repage's "
          f"pack and gather included), plain {plain_ms} ms")
    return results


# ---------------------------------------------------------------- the fleet
def fleet_lib(core, act, fleet, service, lst, workload, data):
    """The modules the fleet phases run on: the port's in this script
    (``PORT``); the parity tests pass the JAX package's."""
    return types.SimpleNamespace(core=core, act=act, fleet=fleet,
                                 service=service, lst=lst, wl=workload,
                                 data=data)


PORT = fleet_lib(port_core, port_act, port_fleet, port_service, port_lst,
                 port_workload, port_data)


def corpus_streams(wl, fspec, rng, namespace: str = "train"):
    """``setup_fleet``'s class mix over ``fspec.n_tables`` corpus tables
    (the same seeded shuffle, ``src/repro/lst/workload.py:235-241``) and
    each class's stream (:258-273)."""
    n = fspec.n_tables
    kinds = (["append_storm"] * int(round(n * fspec.storm_fraction))
             + ["interactive"] * int(round(n * fspec.bursty_fraction))
             + ["cold"] * int(round(n * fspec.cold_fraction)))
    kinds += ["dashboard"] * (n - len(kinds))
    rng.shuffle(kinds)
    streams = []
    for i, kind in enumerate(kinds):
        kw = dict(kind=kind, table=f"corpus{i:02d}", namespace=namespace)
        if kind == "append_storm":
            st = wl.StreamSpec(**kw, reads_per_hour=2.0,
                               writes_per_hour=fspec.storm_writes_per_hour,
                               files_per_write=fspec.storm_files_per_write)
        elif kind == "interactive":
            st = wl.StreamSpec(**kw, reads_per_hour=6.0, writes_per_hour=2.0)
        elif kind == "cold":
            st = wl.StreamSpec(**kw, reads_per_hour=0.2, writes_per_hour=0.1,
                               files_per_write=(1, 4))
        else:
            st = wl.StreamSpec(**kw, reads_per_hour=6.0, writes_per_hour=1.0)
        streams.append(st)
    return streams


def intensity(kind: str, hour: float, rng) -> float:
    """``WorkloadGenerator._intensity`` for the fleet's four stream kinds,
    drawing from the same generator in the same place."""
    if kind == "dashboard":
        return 1.0 + 0.5 * math.sin(2 * math.pi * hour / 24.0)
    if kind == "interactive":
        return 3.0 if rng.rand() < 0.2 else 0.3
    return 1.0


class CorpusFleet:
    """``fleet/corpus``: AutoComp as a service over training-corpus
    tables. ``n_tables`` token-shard tables take ``setup_fleet``'s class
    mix and streams; each sim-hour of ingest draws reads and writes as
    ``WorkloadGenerator.run_hour`` does (4 substeps, Poisson counts from
    one ``RandomState(seed)``), writes ``factor`` times the stream's files
    per write as shards of ``tokens_per_shard`` zipf tokens, and records
    every read and write as a ``QueryEvent`` in the tracker the fleet
    classifies from. An ``AutoCompService(mode="both")`` ticks a
    ``FleetScheduler`` whose class pipelines merge through ``merge_fn``."""

    def __init__(self, lib, merge_fn, n_tables: int, tokens_per_shard: int,
                 factor: float, seed: int, selectivity: float) -> None:
        wl = lib.wl
        self.lib = lib
        self.fspec = wl.FleetSpec(n_tables=n_tables, seed=seed,
                                  gdpr_selectivity=selectivity)
        self.tokens_per_shard = tokens_per_shard
        self.factor = factor
        self.clock = wl.SimClock()
        self.store = lib.lst.InMemoryStore()
        self.catalog = lib.lst.Catalog(self.store, now_fn=self.clock.now)
        self.rng = np.random.RandomState(seed)
        self.cost = wl.CostModel()
        self.streams = corpus_streams(wl, self.fspec, self.rng)
        self.writers = {}
        for i, st in enumerate(self.streams):
            t = self.catalog.create_table(
                st.namespace, st.table,
                properties={"conflict_granularity": "table"})
            t.now_fn = self.clock.now
            self.writers[st.table] = lib.data.TokenShardWriter(
                t, vocab=32000, seed=seed + i)
        self.tracker = wl.ActivityTracker(now_fn=self.clock.now)
        self.ingest_s = []

        def pipeline(profile, activity=None, stats=None):
            return lib.fleet.build_class_pipeline(
                profile, activity, stats=stats,
                scheduler=lib.act.Scheduler(profile.target_file_mb * MIB,
                                            merge_fn=merge_fn))
        self.fleet = lib.fleet.FleetScheduler(
            self.catalog, budget_gbhr=0.0, activity=self.tracker,
            pipeline_factory=pipeline)
        self.service = lib.service.AutoCompService(
            self.catalog, self.fleet,
            lib.service.ServiceConfig(interval_hours=1.0, mode="both"),
            now_fn=self.clock.now)

    def ingest_hour(self, substeps: int = 4) -> None:
        """One sim-hour of reads and writes, recorded in the tracker."""
        out = []
        for _ in range(substeps):
            self.clock.advance(1.0 / substeps)
            now = self.clock.now()
            for st in self.streams:
                table = self.catalog.get_table(st.namespace, st.table)
                inten = intensity(st.kind, now, self.rng)
                n_reads = self.rng.poisson(st.reads_per_hour * inten
                                           / substeps)
                n_writes = self.rng.poisson(st.writes_per_hour * inten
                                            / substeps)
                for _ in range(n_reads):
                    files = table.scan()
                    out.append(self.lib.wl.QueryEvent(
                        now, "read", table.table_id,
                        latency=self.cost.read_latency_s(files),
                        files_scanned=len(files)))
                for _ in range(n_writes):
                    n = max(1, round(self.rng.randint(*st.files_per_write)
                                     * self.factor))
                    self.writers[st.table].trickle_append(
                        n, self.tokens_per_shard)
                    self.catalog.notify_write(table)
                    out.append(self.lib.wl.QueryEvent(
                        now, "write", table.table_id, files_written=n))
        self.tracker.record(out)

    def pooled_cost(self) -> float:
        """Sum of ``compute_cost`` over the candidates a fleet cycle would
        pool now: classify and propose as ``FleetScheduler.run_cycle``
        does, select nothing."""
        fleet = self.fleet
        tables = self.catalog.tables()
        groups = {}
        for t in sorted(tables, key=lambda t: t.table_id):
            groups.setdefault(fleet.classify(t), []).append(t)
        pool = []
        for cls in sorted(groups):
            cands = fleet.pipelines[cls].propose(self.catalog,
                                                 tables=groups[cls])
            cap = fleet.profiles[cls].top_k
            pool += cands if cap is None else cands[:cap]
        pool += fleet.retention.propose(tables, activity=self.tracker)
        return sum(c.traits["compute_cost"] for c in pool)

    def gdpr_tables(self) -> tuple:
        ids = sorted(t.table_id for t in self.catalog.tables())
        return tuple(ids[::max(1, self.fspec.gdpr_table_stride)])

    def submit_gdpr(self, drop_rows) -> None:
        self.fleet.submit_delete(self.lib.lst.PredicateDelete(
            "gdpr-erasure", row_predicate=drop_rows,
            est_selectivity=self.fspec.gdpr_selectivity,
            tables=self.gdpr_tables()))

    def run(self, hours: int, drop_rows, tick=None) -> list:
        """``hours`` sim-hours of ingest, the service ticking after each.
        The budget is set before the first tick to half the pooled cost;
        the delete is submitted before the second. ``tick(fn)`` wraps each
        tick (timing, checks). Returns the reports."""
        reports = []
        for hour in range(hours):
            t0 = time.perf_counter()
            self.ingest_hour()
            self.ingest_s.append(time.perf_counter() - t0)
            if hour == 0:
                self.fleet.budget_gbhr = 0.5 * self.pooled_cost()
            if hour == 1:
                self.submit_gdpr(drop_rows)
            reports.append(tick(self.service.tick) if tick
                           else self.service.tick())
        return reports


def rows_after_delete(inputs, drop_rows):
    """numpy's rewrite-delete of one bin: the rows ``keep & valid``
    selects from the inputs' padded payloads, the count of content rows
    the predicate drops and the count of content rows. ``inputs``:
    (DataFile, raw bytes) pairs."""
    payloads = [decode_shard_padded(raw) for _, raw in inputs]
    rows = np.concatenate(payloads).reshape(-1, CHUNK_COLS)
    valid = np.zeros(rows.shape[0], bool)
    row0 = 0
    for (f, _), p in zip(inputs, payloads):
        valid[row0: row0 + -(-f.num_rows // CHUNK_COLS)] = True
        row0 += p.shape[0] // CHUNK_COLS
    drop = drop_rows(rows)
    return rows[valid & ~drop].reshape(-1), int((valid & drop).sum()), \
        int(valid.sum())


class MergeCheck:
    """Wraps a merge: keeps each merge's input bytes, output bytes and
    result, so that after the tick every file a cycle wrote is held
    against numpy. It records only; the merge is ``merge_fn``'s."""

    def __init__(self, merge_fn):
        self.merge_fn = merge_fn
        self.records = []

    def __call__(self, table, task, out_path, filter_fn=None,
                 fused_filter=True, **kw):
        inputs = [(f, table.store.get(f.path)) for f in task.inputs]
        res = self.merge_fn(table, task, out_path, filter_fn=filter_fn,
                            fused_filter=fused_filter, **kw)
        self.records.append((inputs, table.store.get(out_path),
                             filter_fn is not None, res))
        return res

    def verify(self, drop_rows) -> dict:
        """Compactions hold numpy's concatenation of their inputs;
        rewrite-deletes numpy's ``keep & valid`` rows, with the merge's
        ``rows_dropped`` equal to numpy's count. Clears the records."""
        n = {"compactions": 0, "rewrite_deletes": 0, "rows_dropped": 0,
             "bytes_in": 0}
        for inputs, out_raw, filtered, res in self.records:
            got = decode_shard(out_raw)
            n["bytes_in"] += sum(len(raw) for _, raw in inputs)
            if filtered:
                want, dropped, _ = rows_after_delete(inputs, drop_rows)
                assert res[1] == dropped, (res[1], dropped)
                n["rewrite_deletes"] += 1
                n["rows_dropped"] += dropped
            else:
                want = np.concatenate([decode_shard(raw)
                                       for _, raw in inputs])
                n["compactions"] += 1
            assert np.array_equal(got, want), [f.path for f, _ in inputs]
        self.records = []
        return n


FLEET_CLASSES = ("append-storm", "bursty", "cold", "steady")


def phase_corpus_fleet(args, dev):
    """Phase 7: ``fleet/corpus`` on the card, every merge checked."""
    check = MergeCheck(functools.partial(packing.merge_shards_fn,
                                         device=dev))
    drop_rows = gdpr_rows(args.selectivity)
    cf = CorpusFleet(PORT, check, FLEET_TABLES, args.tokens_per_shard,
                     FLEET_FACTOR, args.seed, args.selectivity)
    print(f"fleet/corpus: {FLEET_TABLES} tables, streams "
          f"{json.dumps({s.table: s.kind for s in cf.streams})}; shards of "
          f"{args.tokens_per_shard} tokens, {FLEET_FACTOR} x each "
          f"stream's files per write; {FLEET_HOURS} sim-hours; GDPR "
          f"delete on {list(cf.gdpr_tables())} at selectivity "
          f"{args.selectivity}")
    walls = []
    seen = set()
    # each cycle's pooled candidates, recorded as decide receives them, so
    # that each tick can name the table that waits longest and price it
    pools = []
    decide = cf.fleet.decide

    def recording_decide(pool):
        pools.append(list(pool))
        return decide(pool)

    cf.fleet.decide = recording_decide

    def tick(fn):
        if not walls:
            print(f"fleet/corpus budget: {cf.fleet.budget_gbhr} GBHr, half "
                  f"the pooled compute_cost before the first tick")
        packing.reset_stage_seconds()
        t1 = time.perf_counter()
        rep = fn()
        sync(dev)
        wall = time.perf_counter() - t1
        assert rep is not None, "the service did not tick"
        split = dict(packing.STAGE_SECONDS)
        split["outside_merge"] = wall - sum(split.values())
        n = check.verify(drop_rows)
        assert rep.act.failures == 0 and rep.act.conflicts == 0
        assert rep.spent_gbhr <= rep.budget_gbhr, (rep.spent_gbhr,
                                                   rep.budget_gbhr)
        assert rep.rows_dropped == n["rows_dropped"], (rep.rows_dropped, n)
        seen.update(rep.class_counts)
        tables = cf.catalog.tables()
        files = sum(t.file_count() for t in tables)
        byts = sum(t.total_bytes() for t in tables)
        walls.append(wall)
        print(f"fleet/corpus tick {len(walls)} (sim-hour {cf.clock.now()}): "
              f"ingest {cf.ingest_s[-1]} s; wall {wall} s; split "
              f"(s) {json.dumps(split)}; class_counts "
              f"{json.dumps(rep.class_counts)}, n_candidates "
              f"{rep.n_candidates}, n_selected {rep.n_selected}, "
              f"n_delete_candidates {rep.n_delete_candidates}, spent_gbhr "
              f"{rep.spent_gbhr} of budget_gbhr {rep.budget_gbhr}, "
              f"max_skip_cycles {rep.max_skip_cycles}, files_removed "
              f"{rep.files_removed}, rows_dropped {rep.rows_dropped}; "
              f"merges checked {json.dumps(n)}; fleet now {files} files, "
              f"{byts} bytes")
        skips = cf.fleet.skip_cycles
        if skips:
            tid = max(sorted(skips), key=skips.get)
            queued = [["delete" if c.delete_route is not None
                       else "compaction", c.traits["compute_cost"]]
                      for c in pools[-1] if c.table.table_id == tid]
            print(f"fleet/corpus tick {len(walls)} starved: {tid} skipped "
                  f"{skips[tid]} cycles; its queued shares' compute_cost "
                  f"{json.dumps(queued)} GBHr against budget_gbhr "
                  f"{rep.budget_gbhr}")
        return rep

    kern.reset_launches()
    reports = cf.run(FLEET_HOURS, drop_rows, tick)
    launches = dict(kern.LAUNCHES)
    # the delete's shares still queued, priced now: select_budget skips a
    # candidate that alone costs more than the budget, in every cycle
    queue = cf.fleet.retention
    pending = {c.table.table_id: c.traits["compute_cost"] for c in
               queue.propose(queue.target_tables(cf.catalog))}
    total = sum(t.total_bytes() for t in cf.catalog.tables())
    print(f"fleet/corpus: {sum(r.files_removed for r in reports)} files "
          f"removed, {sum(r.rows_dropped for r in reports)} rows dropped "
          f"over {len(reports)} ticks; fleet holds {total} bytes "
          f"({total / (1 << 30)} GiB); classes seen {sorted(seen)}; "
          f"delete still queued on (table: compute_cost) "
          f"{json.dumps(pending)} against budget {cf.fleet.budget_gbhr}; "
          f"launches {json.dumps(launches)}")
    assert sorted(seen) == sorted(FLEET_CLASSES), sorted(seen)
    assert sum(r.rows_dropped for r in reports) > 0
    assert all(cost > cf.fleet.budget_gbhr for cost in pending.values()), \
        pending
    phase_corpus_pipeline(args, dev, cf)
    return launches


def phase_corpus_pipeline(args, dev, cf):
    """The compacted table with the most tokens through ``DataPipeline``
    on the card at ``train_4k``'s micro-batch, each batch against numpy's
    packing and permutation of the same stream, plain and prefetching."""
    batch, seq = TRAIN_4K_MICROBATCH, TRAIN_4K_SEQ
    table = max(cf.catalog.tables(),
                key=lambda t: (sum(f.num_rows for f in t.current_files()),
                               t.table_id))
    files = sorted((f for f in table.current_files()
                    if f.path.endswith(".toks")), key=lambda f: f.path)
    stream = np.concatenate([decode_shard(cf.store.get(f.path))
                             for f in files])
    per = batch * (seq + 1)
    slabs = stream[: stream.shape[0] // per * per].reshape(-1, batch,
                                                           seq + 1)
    order = np.random.RandomState(args.seed).permutation(len(slabs))
    for prefetch in (False, True):
        pipe = DataPipeline(table, batch, seq, seed=args.seed, device=dev)
        it = pipe.prefetching_batches() if prefetch else pipe.batches()
        t0 = time.perf_counter()
        n = 0
        for b in it:
            assert n < len(order), "more batches than numpy's packing"
            slab = slabs[order[n]]
            for key, want in (("tokens", slab[:, :-1]),
                              ("labels", slab[:, 1:])):
                got = b[key]
                assert got.device == dev and got.dtype == torch.int32 \
                    and tuple(got.shape) == (batch, seq), (key, got.shape)
                assert np.array_equal(got.cpu().numpy(), want), (key, n)
            n += 1
        wall = time.perf_counter() - t0
        assert n == len(slabs), (n, len(slabs))
        path = "prefetching" if prefetch else "plain"
        print(f"fleet/corpus pipeline ({path}): {table.table_id}, "
              f"{len(files)} files, {stream.shape[0]} tokens -> {n} "
              f"batches of ({batch}, {seq}) on {dev}, each equal to "
              f"numpy's; wall {wall} s (checks included); "
              f"plan_time_s {pipe.plan_time_s}, read_time_s "
              f"{pipe.read_time_s}, h2d {pipe.h2d_time_s} s")


def make_fleet(lib, fspec, budget_gbhr: float, warmup_hours: int = 1,
               starvation_cycles: int = 4):
    """``benchmarks/workload_sim.py::make_fleet``: the storm-mix fleet
    after ``warmup_hours`` of ingest, its tracker wired into the
    scheduler."""
    wl = lib.wl
    clock = wl.SimClock()
    store = lib.lst.InMemoryStore()
    catalog = lib.lst.Catalog(store, now_fn=clock.now)
    gen = wl.WorkloadGenerator(catalog, wl.WorkloadSpec(seed=fspec.seed),
                               clock)
    gen.setup_fleet(fspec)
    tracker = wl.ActivityTracker(now_fn=clock.now)
    for _ in range(warmup_hours):
        tracker.record(gen.run_hour(substeps=1))
    fleet = lib.fleet.FleetScheduler(catalog, budget_gbhr=budget_gbhr,
                                     activity=tracker,
                                     starvation_cycles=starvation_cycles)
    return clock, catalog, gen, tracker, fleet


def submit_retention_ops(lib, fleet, catalog, fspec) -> None:
    """``benchmarks/bench_fleet.py::submit_retention_ops``: a standing TTL
    and a one-shot GDPR delete on every ``gdpr_table_stride``-th table,
    whose predicate hashes the synthetic row id."""
    fleet.submit_retention(lib.lst.RetentionPolicy(
        "ttl", max_age_hours=fspec.retention_max_age_hours))
    stride = max(1, fspec.gdpr_table_stride)
    tids = sorted(t.table_id for t in catalog.tables())[::stride]
    sel = fspec.gdpr_selectivity

    def gdpr_ids(rows, task, _s=sel):
        ids = np.asarray(rows)[:, 0].astype(np.int64)
        return ((ids * 2654435761) % (1 << 32)) < int(_s * (1 << 32))

    fleet.submit_delete(lib.lst.PredicateDelete(
        "gdpr-erasure", row_predicate=gdpr_ids, est_selectivity=sel,
        tables=tuple(tids)))


def storm_fleet(lib, fspec, cycles: int, budget_gbhr: float,
                starvation_cycles: int = 4, cycle=None):
    """``bench_fleet.py::run_fleet`` with retention: ``cycles`` rounds of
    one sim-hour of ingest and one fleet cycle. ``cycle(fn)`` wraps each
    cycle. Returns the fleet, the generator and, per cycle, (report, file
    count before, file count after)."""
    _, catalog, gen, tracker, fleet = make_fleet(
        lib, fspec, budget_gbhr, starvation_cycles=starvation_cycles)
    submit_retention_ops(lib, fleet, catalog, fspec)
    per_cycle = []
    for _ in range(cycles):
        tracker.record(gen.run_hour(substeps=1))
        before = gen.total_file_count()
        rep = cycle(fleet.run_cycle) if cycle else fleet.run_cycle()
        per_cycle.append((rep, before, gen.total_file_count()))
    return fleet, gen, per_cycle


def phase_storm_fleet(args):
    """Phase 8: ``fleet/storm-2k``, the control plane at the paper's scale
    on the host, with the port's default merge."""
    fspec = port_workload.FleetSpec(seed=args.seed)
    walls = []

    def cycle(fn):
        t0 = time.perf_counter()
        rep = fn()
        walls.append(time.perf_counter() - t0)
        return rep

    t0 = time.perf_counter()
    fleet, gen, per_cycle = storm_fleet(PORT, fspec, STORM_CYCLES,
                                        STORM_BUDGET_GBHR, cycle=cycle)
    wall = time.perf_counter() - t0
    for i, ((rep, before, after), w) in enumerate(zip(per_cycle, walls)):
        print(f"fleet/storm-2k cycle {i + 1}: wall {w} s; files {before} -> "
              f"{after}; class_counts {json.dumps(rep.class_counts)}, "
              f"n_candidates {rep.n_candidates}, n_selected "
              f"{rep.n_selected}, n_delete_candidates "
              f"{rep.n_delete_candidates}, spent_gbhr {rep.spent_gbhr} of "
              f"budget_gbhr {rep.budget_gbhr}, max_skip_cycles "
              f"{rep.max_skip_cycles}, files_removed {rep.files_removed}, "
              f"rows_dropped {rep.rows_dropped}, files_dropped "
              f"{rep.files_dropped}")
        assert rep.spent_gbhr <= rep.budget_gbhr, (i, rep.spent_gbhr)
        assert rep.max_skip_cycles <= fleet.starvation_cycles, i
        assert after < before, (i, before, after)
    print(f"fleet/storm-2k: {fspec.n_tables} tables, {STORM_CYCLES} "
          f"cycles under {STORM_BUDGET_GBHR} GBHr with retention; wall "
          f"{wall} s (setup and ingest included), cycles {sum(walls)} s; "
          f"totals {json.dumps(fleet.totals())}; files at the end "
          f"{gen.total_file_count()}")


# ---------------------------------------------------------------- the model
def model_batch(cfg, batch: int, seq: int, seed: int, dtype, dev) -> dict:
    """A train batch of ``input_specs``'s shapes
    (``src/repro/configs/shapes.py:105-133``) from a numpy seed: tokens and
    labels, or audio frames with a loss mask, or patches with the text
    tokens after them; float inputs in ``dtype``."""
    rng = np.random.default_rng(seed)
    n = seq - cfg.n_vision_tokens if cfg.frontend == "vit_patches" else seq
    out = {}
    if cfg.frontend == "audio_frames":
        out["frames"] = rng.standard_normal(
            (batch, seq, model_tf.AUDIO_HIDDEN), dtype=np.float32)
        out["mask"] = rng.random((batch, seq)) < 0.3
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (batch, n), dtype=np.int32)
    if cfg.frontend == "vit_patches":
        out["patches"] = rng.standard_normal(
            (batch, cfg.n_vision_tokens, model_tf.VIT_HIDDEN),
            dtype=np.float32)
    out["labels"] = rng.integers(0, cfg.vocab, (batch, n), dtype=np.int32)
    return {k: torch.from_numpy(v).to(device=dev, dtype=dtype)
            if v.dtype == np.float32 else torch.from_numpy(v).to(dev)
            for k, v in out.items()}


def loss_and_grads(cfg, params, batch):
    """One forward+backward of ``forward(mode="train")``: the loss, the
    metrics and every leaf's gradient (zeros where the loss does not
    reach a leaf), in the tree's leaf order."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.grad = None
        t.requires_grad_(True)
    loss, metrics = model_tf.forward(cfg, params, batch)
    loss.backward()
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            [torch.zeros_like(t) if t.grad is None else t.grad
             for t in leaves])


def grad_err(got, want) -> float:
    """The largest leaf error over the f32 bar: <= 1 passes."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        scale = float(w.abs().max()) if w.numel() else 0.0
        err = float((g - w).abs().max()) if w.numel() else 0.0
        worst = max(worst, err / (MODEL_GRAD_TOL * scale + MODEL_GRAD_FLOOR))
    return worst


def phase_model_families(seed: int, dev) -> None:
    """One model per family at its ``smoke_config`` in f32: the port on
    the card against the port on the CPU, the same weights and batch.
    Both f32 paths keep TF32 off (PyTorch's default), so the card's
    products round as f32 products do."""
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    cpu = torch.device("cpu")
    for arch in MODEL_FAMILY_ARCHS:
        cfg = smoke_config(arch)
        params = tree_map(lambda t: t.float(),
                          model_tf.init_params(cfg, seed=seed, device=cpu))
        batch = model_batch(cfg, 2, 16, seed, torch.float32, cpu)
        loss_c, met_c, g_c = loss_and_grads(cfg, params, batch)
        on_dev = tree_map(lambda t: t.detach().to(dev), params)
        loss_d, met_d, g_d = loss_and_grads(
            cfg, on_dev, {k: v.to(dev) for k, v in batch.items()})
        assert all(g.device.type == dev.type for g in g_d)
        lc, ld = float(loss_c), float(loss_d)
        loss_rel = abs(ld - lc) / max(1.0, abs(lc))
        met_rel = max(abs(float(met_d[k]) - float(v)) / max(1.0, abs(float(v)))
                      for k, v in met_c.items())
        gerr = grad_err(g_d, g_c)
        print(f"model/{arch} smoke f32, card against CPU: loss {ld} / {lc}, "
              f"rel err {loss_rel}; metrics {sorted(met_d)} worst rel err "
              f"{met_rel}; {len(g_d)} gradient leaves, worst err "
              f"{gerr} of the bar (err / ({MODEL_GRAD_TOL} x scale + "
              f"{MODEL_GRAD_FLOOR}))")
        assert sorted(met_d) == sorted(met_c), (arch, sorted(met_d))
        assert loss_rel <= MODEL_LOSS_TOL and met_rel <= MODEL_LOSS_TOL, \
            (arch, loss_rel, met_rel)
        assert gerr <= 1.0, (arch, gerr)


def profile_step(step, top: int = 10,
                 label: str = f"model/{MODEL_ARCH}") -> None:
    """One more call of ``step`` under ``torch.profiler``, tracing the
    device only: the kernels' busy time against the call's wall, so the
    device's idle share, the kernels launched, and the device time of the
    ``top`` kernel families (a kernel's name up to its template
    arguments). The profiler's own cost is inside this wall, not the
    timed ones."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, kernels = {}, 0
    for e in prof.key_averages():
        name = re.split(r"[<(]", e.key.removeprefix("void "), 1)[0][:48]
        by_name[name] = by_name.get(name, 0.0) + e.self_device_time_total / 1e3
        kernels += e.count if e.self_device_time_total > 0 else 0
    busy_ms = sum(by_name.values())
    top_ms = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])
    print(f"{label} profiled call: wall {wall_ms} ms, device "
          f"busy {busy_ms} ms, idle share {1 - busy_ms / wall_ms}; "
          f"{kernels} device activities; device "
          f"ms by kernel (top {top}) {json.dumps(top_ms)}")
    assert busy_ms > 0, "the profiler saw no device time"


def phase_model_full_width(args, dev, smi: str) -> None:
    """paper-lm-100m at full width in bf16, seq 4096, ``--model-batch``
    rows: one forward+backward timed over ``MODEL_REPS`` calls after a
    warm-up, its peak memory and throughput; the loss at init near
    ln(vocab), every gradient leaf finite and nonzero; the bf16 loss
    against f32 on the same weights at batch 1."""
    cfg = get_config(MODEL_ARCH)
    seq, rows = TRAIN_4K_SEQ, args.model_batch
    params = model_tf.init_params(cfg, seed=args.seed, device=dev)
    # N for 6 N tokens: the tree's leaves (ModelConfig.param_count() leaves
    # out the final norm's d_model)
    n_params = sum(t.numel() for t in tree_leaves(params))
    assert n_params == cfg.param_count() + cfg.d_model, n_params
    batch = model_batch(cfg, rows, seq, args.seed, torch.bfloat16, dev)
    out = {}

    def step():
        out["r"] = loss_and_grads(cfg, params, batch)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = time_ms(step, MODEL_REPS, warmup=1)
    peak_gib = torch.cuda.max_memory_allocated(dev) / (1 << 30)
    profile_step(step)
    loss, metrics, grads = out["r"]
    tokens = rows * seq
    # every (q tile, kv tile) the blockwise path computes, masked or not:
    # q k^T and p v, 4 B H S^2 D a layer forward, twice that backward; the
    # recompute's second forward is not counted, as 6 N tokens counts none
    attn_flops = 12 * cfg.n_layers * rows * cfg.n_heads * seq * seq \
        * cfg.head_dim
    flops = 6 * n_params * tokens + attn_flops
    tflops = flops / (ms / 1e3) / 1e12
    ln_v = math.log(cfg.vocab)
    print(f"model/{MODEL_ARCH} bf16 full width ({cfg.n_layers} x "
          f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, "
          f"vocab {cfg.vocab}, {n_params} parameters), batch {rows} x {seq}: "
          f"forward+backward {ms} ms (median of {MODEL_REPS} after a "
          f"warm-up); {tokens / (ms / 1e3)} tokens/s; peak "
          f"{peak_gib} GiB (max_memory_allocated); {flops} flops "
          f"(6 N tokens {6 * n_params * tokens} + blockwise attention "
          f"{attn_flops}) = {tflops} TFLOP/s, {tflops * 1e12 / BF16_FLOPS_PER_S}"
          f" of the {BF16_FLOPS_PER_S / 1e12:g} TFLOP/s bf16 dense peak "
          f"({smi}); loss {float(loss)} against ln(vocab) {ln_v}")
    assert math.isfinite(float(loss)) and abs(float(loss) - ln_v) < 0.1, \
        float(loss)
    bad = [i for i, g in enumerate(grads)
           if not (bool(torch.isfinite(g).all()) and bool((g != 0).any()))]
    assert not bad, ("gradient leaves not finite or all zero", bad)

    one = {k: v[:1] for k, v in batch.items()}
    with torch.no_grad():
        l16 = float(model_tf.forward(cfg, params, one)[0])
        p32 = tree_map(lambda t: t.detach().float(), params)
        l32 = float(model_tf.forward(cfg, p32, one)[0])
    rel = abs(l16 - l32) / abs(l32)
    print(f"model/{MODEL_ARCH} bf16 against f32, same weights, batch 1 x "
          f"{seq}: loss {l16} / {l32}, rel err {rel} (bar {ROW_REL_BAR[torch.bfloat16]})")
    assert rel <= ROW_REL_BAR[torch.bfloat16], rel
    del params, batch, out, grads, p32
    return ms


def phase_model_xlstm(args, dev) -> None:
    """xlstm-125m at full width in bf16, batch 2 x 256: one
    forward+backward, finite, every gradient leaf finite; then the sLSTM
    sequence's ``autograd.Function`` against plain autograd through the
    per-step cell, on the card at that width in f32."""
    cfg = get_config("xlstm-125m")
    params = model_tf.init_params(cfg, seed=args.seed, device=dev)
    batch = model_batch(cfg, XLSTM_BATCH, XLSTM_SEQ, args.seed,
                        torch.bfloat16, dev)
    out = {}

    def step():
        out["r"] = loss_and_grads(cfg, params, batch)

    torch.cuda.reset_peak_memory_stats(dev)
    ms = time_ms(step, 1, warmup=0)
    loss, _, grads = out["r"]
    peak_gib = torch.cuda.max_memory_allocated(dev) / (1 << 30)
    bad = [i for i, g in enumerate(grads) if not bool(torch.isfinite(g).all())]
    print(f"model/xlstm-125m bf16 full width ({cfg.n_layers} blocks x "
          f"{cfg.d_model}, vocab {cfg.vocab}), batch {XLSTM_BATCH} x "
          f"{XLSTM_SEQ}: one forward+backward {ms} ms (its first call), "
          f"peak {peak_gib} GiB, "
          f"loss {float(loss)}")
    assert math.isfinite(float(loss)) and not bad, (float(loss), bad)

    blk = params["blocks"][1]
    assert not model_xlstm.is_mlstm_layer(cfg, 1)
    d, h = cfg.d_model, cfg.n_heads
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    gx = torch.randn((XLSTM_SEQ, XLSTM_BATCH, 4, d), generator=gen,
                     device=dev)
    bg = torch.randn((4, d), generator=gen, device=dev) * 0.1
    r = blk["r_gates"].detach().float()
    zeros = torch.zeros((XLSTM_BATCH, d), device=dev)

    def run(seq_fn):
        ins = [t.clone().requires_grad_() for t in (r, bg, gx)]
        ys, final = seq_fn(h, *ins, (zeros,) * 4)
        val = (ys ** 2).sum() + sum(f.sum() for f in final)
        val.backward()
        return float(val.detach()), [t.grad for t in ins]

    def plain(n_heads, rg, bgs, gxs, state):
        ys = []
        for t in range(gxs.shape[0]):
            state = model_xlstm._slstm_cell_raw(n_heads, rg, bgs, gxs[t], state)
            ys.append(state[0])
        return torch.stack(ys), state

    v_fn, g_fn = run(model_xlstm._slstm_sequence)
    v_pl, g_pl = run(plain)
    v_rel = abs(v_fn - v_pl) / max(1.0, abs(v_pl))
    g_rel = max(float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(g_fn, g_pl))
    print(f"model/xlstm-125m sLSTM autograd.Function against plain autograd "
          f"on the card (f32, S {XLSTM_SEQ}, B {XLSTM_BATCH}, d {d}, "
          f"{h} heads): value {v_fn} / {v_pl}, rel err {v_rel}; gradients "
          f"(r_gates, b_gates, gates_x) worst err / scale {g_rel}")
    assert v_rel <= 1e-5 and g_rel <= 1e-4, (v_rel, g_rel)


def phase_model(args, dev, smi: str) -> float:
    """Phase 9: the model's training math on the card. No kernel of the
    registry lies on this path (the reference's model calls none of its
    Pallas kernels), so every launch count stays 0. Returns the full-width
    forward+backward ms."""
    walls, out = {}, {}
    kern.reset_launches()
    reset_sweep_launches()
    for part, fn in (("families", lambda: phase_model_families(args.seed, dev)),
                     ("full width", lambda: phase_model_full_width(args, dev, smi)),
                     ("xlstm", lambda: phase_model_xlstm(args, dev))):
        t0 = time.perf_counter()
        out[part] = fn()
        walls[part] = time.perf_counter() - t0
    launches = {**dict(kern.LAUNCHES), **sweep_launches()}
    print(f"model/train: launches {json.dumps(launches)} (no kernel on the "
          f"path); phase wall {sum(walls.values())} s, by part (s) "
          f"{json.dumps(walls)}")
    assert not any(launches.values()), launches
    return out["full width"]


# --------------------------------------------------------- the trainer
# train/launch: the launcher at its own defaults (paper-lm-100m, bf16, 60
# steps of 8 x 256 in 2 microbatches, a cycle every 25 steps, a checkpoint
# every 20); then a preemption at step 30, as examples/train_e2e.py makes
# one at 35; then the train step at train_4k's width from a Trainer over
# the launcher's corpus
PREEMPT_AT, RESTORE_STEP = 30, 20
STEP_4K_STEPS = 4


class Timed:
    """Wraps a method of a class for the phase: each call's wall time,
    and what ``after`` reads once the call returns. Restores the method
    on exit."""

    def __init__(self, cls, name: str, after=None):
        self.cls, self.name, self.after = cls, name, after
        self.walls, self.seen = [], []

    def __enter__(self):
        inner = self.inner = getattr(self.cls, self.name)
        timed = self

        def wrapper(obj, *a, **kw):
            t0 = time.perf_counter()
            out = inner(obj, *a, **kw)
            timed.walls.append(time.perf_counter() - t0)
            if timed.after is not None:
                timed.seen.append(timed.after(obj, out, *a))
            return out

        setattr(self.cls, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.inner)


def cycle_files(_pipeline, report, catalog) -> tuple:
    """After a cycle: its report's counts and the catalog's file count."""
    return (report.files_removed, report.gbhr,
            sum(t.file_count() for t in catalog.tables()))


def replay_cycles(args_ns, n_steps: int) -> list:
    """The launcher's data and AutoComp wiring ticked as ``main`` ticks it,
    merged on the host with ``device="cpu"``: each cycle's counts."""
    cfg = get_config(args_ns.arch)
    catalog, _, _, clock, _ = launch_train.build_data(
        cfg, batch=args_ns.batch, seq_len=args_ns.seq_len, device="cpu")
    autocomp = launch_train.build_autocomp(catalog, clock, device="cpu")
    seen = []
    for i in range(1, n_steps + 1):
        clock.advance(0.01)
        if i % args_ns.compact_every == 0:
            seen.append(cycle_files(None, autocomp.run_cycle(catalog),
                                    catalog))
    return seen


def step_ms(history, first: int = 1) -> float:
    return statistics.median(h["time_s"] for h in history[first:]) * 1e3


def phase_train_launcher(smi: str):
    """Run 1: ``launch.train.main([])`` on the card, every merge held
    against numpy, the cycles against a host replay; the kernels' launch
    counts on this path."""
    ns = launch_train.parse_args([])
    check = MergeCheck(packing.merge_shards_fn)
    launch_train.merge_shards_fn = check
    kern.reset_launches()
    reset_sweep_launches()
    try:
        with Timed(CheckpointManager, "save") as saves, \
                Timed(AutoCompPipeline, "run_cycle", cycle_files) as cycles:
            t0 = time.perf_counter()
            out = launch_train.main([])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        launch_train.merge_shards_fn = packing.merge_shards_fn
    launches = {**dict(kern.LAUNCHES), **sweep_launches()}
    hist = out["history"]
    ms = step_ms(hist)
    tokens = ns.batch * ns.seq_len
    merged = check.verify(drop_rows=None)
    print(f"train/launch run 1 ({smi}): main([]) -- {out['launch'].cfg.name}"
          f" bf16, {ns.steps} steps of {ns.batch} x {ns.seq_len} in "
          f"{ns.microbatches} microbatches, grad_transport "
          f"{ns.grad_transport}: wall {wall} s; step {ms} ms (median of "
          f"steps 2-{ns.steps}), first step {hist[0]['time_s'] * 1e3} ms, "
          f"{tokens / (ms / 1e3)} tokens/s; checkpoint saves' blocking part "
          f"{sum(saves.walls)} s over {len(saves.walls)} saves "
          f"({json.dumps(saves.walls)}); AutoComp cycles "
          f"{sum(cycles.walls)} s over {len(cycles.walls)} cycles; loss "
          f"{hist[0]['loss']} -> {hist[-1]['loss']}; launches "
          f"{json.dumps(launches)}; merges checked {json.dumps(merged)}")
    assert out["final_step"] == ns.steps and hist[-1]["loss"] < hist[0]["loss"]
    assert any(c[0] for c in cycles.seen), cycles.seen
    assert launches["compact_chunks"] >= 1, launches
    assert merged["compactions"] >= 1 and merged["rewrite_deletes"] == 0
    tr = out["launch"].trainer
    batches = out["launch"].pipe.batches()
    batch = next(batches)
    batches.close()
    profile_step(lambda: tr.train_step(tr.params, tr.opt_state, batch),
                 label="train/launch step")
    replay = replay_cycles(ns, ns.steps)
    print(f"train/launch cycles (files removed, gbhr, table files): card "
          f"{cycles.seen}, host replay {replay}")
    assert cycles.seen == replay, (cycles.seen, replay)
    return hist, launches


def phase_train_preempt(dev, smi: str, run1) -> None:
    """Run 2: the same wiring through ``Trainer.run_with_recovery`` with a
    preemption at step ``PREEMPT_AT``. Before it, each step's loss is run
    1's within the bf16 bar (the same batches). After the restore the
    Trainer starts its batch iterator afresh (``Trainer.run``, as the
    reference's), so step s sees another batch than in run 1: the mean loss
    over those steps is held to run 1's, and the worst step is printed."""
    fired = []

    def fault(step):
        if step == PREEMPT_AT and not fired:
            fired.append(step)
            raise SimulatedPreemption()

    def restored(_mgr, out, *_a):
        (params, opt, _), step = out
        leaves = tree_leaves((params, opt))
        return step, all(t.device == dev for t in leaves), len(leaves)

    launch = launch_train.build(launch_train.parse_args([]), fault_hook=fault)
    kern.reset_launches()
    with Timed(CheckpointManager, "restore", restored) as restores:
        t0 = time.perf_counter()
        out = launch.trainer.run_with_recovery()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    hist = out["history"]
    steps = [h["step"] for h in hist]
    bar = ROW_REL_BAR[torch.bfloat16]

    def rel(h):
        return abs(h["loss"] - run1[h["step"]]["loss"]) \
            / abs(run1[h["step"]]["loss"])

    before, after = hist[:PREEMPT_AT], hist[PREEMPT_AT:]
    mean2 = statistics.fmean(h["loss"] for h in after)
    mean1 = statistics.fmean(run1[h["step"]]["loss"] for h in after)
    mean_rel = abs(mean2 - mean1) / mean1
    print(f"train/launch run 2 ({smi}): preempted at step {PREEMPT_AT}, "
          f"restored (step, every leaf on {dev}, leaves) {restores.seen} in "
          f"{restores.walls} s, restarts {launch.trainer.restarts}, final "
          f"step {out['final_step']}; wall {wall} s; against run 1 at the "
          f"same steps: before the preemption worst rel diff "
          f"{max(map(rel, before))}, after the restore mean loss {mean2} / "
          f"{mean1} rel diff {mean_rel}, worst step {max(map(rel, after))} "
          f"(bar {bar}); compact_chunks launches "
          f"{kern.LAUNCHES['compact_chunks']}")
    assert launch.trainer.restarts == 1 and out["final_step"] == 60
    assert [s for s, *_ in restores.seen] == [RESTORE_STEP]
    assert all(on_dev for _, on_dev, _ in restores.seen)
    assert steps == list(range(PREEMPT_AT)) + list(range(RESTORE_STEP, 60))
    assert max(map(rel, before)) <= bar and mean_rel <= bar, mean_rel


def timed_batches(factory, waits: list):
    """``factory``'s batches, with the consumer's wait in each ``next``."""
    def gen():
        it = factory()
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    return
                waits.append(time.perf_counter() - t0)
                yield b
        finally:
            it.close()
    return gen


def phase_train_step_4k(args, dev, smi: str, fwd_bwd_ms: float) -> None:
    """The train step at train_4k's width (16 x 4096, one microbatch) from
    a Trainer over a DataPipeline on the launcher's corpus, both
    transports, prefetching and plain; then compressed_psum on one
    full-width leaf, card against CPU."""
    cfg = get_config(MODEL_ARCH)
    rows, seq = args.model_batch, TRAIN_4K_SEQ
    _, table, pipe, _, _ = launch_train.build_data(
        cfg, batch=rows, seq_len=seq, device=dev)
    params = model_tf.init_params(cfg, seed=args.seed, device=dev)
    adamw = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=60)
    for transport in step_lib.GRAD_TRANSPORTS:
        step_fn = step_lib.make_train_step(cfg, adamw, microbatches=1,
                                           grad_transport=transport)
        for mode in ("prefetching", "plain"):
            waits, h2d0 = [], pipe.h2d_time_s
            factory = pipe.prefetching_batches if mode == "prefetching" \
                else pipe.batches
            tr = Trainer(RunnerConfig(total_steps=STEP_4K_STEPS),
                         step_fn, params, opt_lib.init_state(
                             params, error_feedback=transport == "int8_ef"),
                         timed_batches(factory, waits))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            out = tr.run()
            peak = torch.cuda.max_memory_allocated(dev) / (1 << 30)
            hist = out["history"]
            ms = step_ms(hist)
            print(f"train/step_4k ({smi}): {transport}, {mode}: {rows} x "
                  f"{seq}, {STEP_4K_STEPS} steps: step {ms} ms (median of "
                  f"steps 2-{STEP_4K_STEPS}; all {[h['time_s'] * 1e3 for h in hist]}"
                  f"), {ms - fwd_bwd_ms} ms over phase 9's forward+backward "
                  f"{fwd_bwd_ms} ms; {rows * seq / (ms / 1e3)} tokens/s; "
                  f"peak {peak} GiB; wait in next(it) per step (ms) "
                  f"{[w * 1e3 for w in waits]}; loss "
                  f"{hist[0]['loss']} -> {hist[-1]['loss']}; "
                  f"{pipe.files_scanned} files, h2d "
                  f"{pipe.h2d_time_s - h2d0} s")
            assert all(math.isfinite(h["loss"]) for h in hist)
            assert int(tr.opt_state["step"]) == STEP_4K_STEPS
            del tr, out
    del params

    # compressed_psum on the embedding's full-width leaf, card against CPU
    gen = torch.Generator().manual_seed(args.seed)
    shape = (cfg.vocab, cfg.d_model)
    x = torch.randn(shape, generator=gen) \
        * torch.exp(torch.randn(shape, generator=gen) * 3)
    err = torch.randn(shape, generator=gen) * 1e-2
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        o_c, e_c = coll.compressed_psum(xd, None, err)
        o_d, e_d = coll.compressed_psum(xd.to(dev), None, err.to(dev))
        same = same_bits(o_d.cpu(), o_c) and same_bits(e_d.cpu(), e_c)
        print(f"train/step_4k compressed_psum {tuple(shape)} {dtype}: card "
              f"against CPU, outputs and residuals bit-equal: {same}")
        assert same


def phase_train(args, dev, smi: str, fwd_bwd_ms: float) -> int:
    """Phase 10: the trainer on the card. Returns ``compact_chunks``'s
    launches on the launcher's run (the ``train`` path)."""
    walls = {}
    t0 = time.perf_counter()
    run1, launches = phase_train_launcher(smi)
    walls["launcher"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_train_preempt(dev, smi, run1)
    walls["preemption"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_train_step_4k(args, dev, smi, fwd_bwd_ms)
    walls["step_4k"] = time.perf_counter() - t0
    print(f"train/launch: phase wall {sum(walls.values())} s, by part (s) "
          f"{json.dumps(walls)}")
    return launches["compact_chunks"]


# ------------------------------------------------------------ serving
# serve/granite-3-8b: decode_32k's decode (src/repro/configs/shapes.py:35,
# 128 rows x 32768) cut to 8 requests in a 2048-token prompt buffer, each
# of 512-2048 tokens from --seed, 64 new tokens greedy (horizon <= 2112).
# The cut: prefill runs through the plain f32 blockwise attention, whose
# eager tile passes were 73% of the device in phase 9.
SERVE_ARCH = "granite-3-8b"
SERVE_BATCH, SERVE_BUFFER, SERVE_NEW = 8, 2048, 64
SERVE_LEN_RANGE = (512, 2048)
SERVE_SLOTS, SERVE_WORKERS, SERVE_CLASSES = 4, 2, 2
DECODE_32K_ROWS, DECODE_32K_SEQ = 128, 32768
# the serve steps' CPU bars (tests/test_torch_serve_steps.py), and the
# reference's bars for quantized storage against bf16
# (tests/test_serve.py:192, :253)
SERVE_F32_TOL = 2e-6
STORAGE_BARS = {"int8": 0.05, "f8": 0.08}
SERVE_PROFILE_CALL = 3        # the decode call profiled in each mode


class ServeProbe:
    """Wraps the serve steps that ``serve.generate`` builds while it is
    entered: each prefill's and decode's wall (host clock ending in a
    synchronize, as the engine's own argmax syncs every step), the first
    prefill's and decode's logits, every logit finite, the paged store's
    gather and scatter walls, and one decode call under the profiler.
    The slot engine's decode is timed where the engine steps it
    (``serve._SlotStep``): on one card its steps replay a CUDA graph,
    which calls no decode function, and its capture allows no sync."""

    def __init__(self, label: str, profile_call=None, keep_all=False):
        self.label, self.profile_call = label, profile_call
        self.keep_all = keep_all
        self.prefill_s, self.decode_s, self.gather_s, self.scatter_s = \
            [], [], [], []
        self.prefill_logits, self.decode_logits = [], []
        self.first_decode_tokens = None   # the first decode call's input
        self.t0 = self.ttft_s = None
        self.finite, self.n_decode = True, 0
        self.in_step = False              # inside a slot engine's step

    def _sync(self, out):
        leaf = tree_leaves(out)[0]
        if leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)

    def _timed(self, fn, walls, logits, after=None):
        probe = self

        def wrapped(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            probe._sync(out)
            walls.append(time.perf_counter() - t0)
            if after is not None:
                after(out)
            if logits is not None:
                lg = serve._full(out[0] if isinstance(out, tuple) else out)
                probe.finite &= bool(torch.isfinite(lg.float()).all())
                if probe.keep_all or not logits:
                    logits.append(lg.detach().float().cpu())
            return out
        return wrapped

    def _decode(self, timed, tokens, args):
        """One decode step through ``timed``; ``tokens()`` its input
        tokens on the host."""
        self.n_decode += 1
        if self.first_decode_tokens is None:
            self.first_decode_tokens = tokens()
        if self.n_decode == self.profile_call:
            out = []
            profile_step(lambda: out.append(timed(*args)),
                         label=f"{self.label} decode step "
                               f"{self.profile_call}")
            self.decode_s.pop()      # the profiled call's wall
            return out[0]
        return timed(*args)

    def __enter__(self):
        self.real = (step_lib.make_prefill_step, step_lib.make_decode_step,
                     model_registry.PagedStateStore.gather_dense,
                     model_registry.PagedStateStore.scatter_dense,
                     serve._SlotStep.__call__)
        real_pre, real_dec, real_g, real_s, real_step = self.real
        probe = self

        def first_token(out):
            if probe.ttft_s is None:
                probe.ttft_s = time.perf_counter() - probe.t0

        def make_prefill(*a, **kw):
            return probe._timed(real_pre(*a, **kw), probe.prefill_s,
                                probe.prefill_logits, first_token)

        def make_decode(*a, **kw):
            real = real_dec(*a, **kw)
            timed = probe._timed(real, probe.decode_s, probe.decode_logits)

            def decode(*args):
                if probe.in_step:     # timed by the slot step around it
                    return real(*args)
                return probe._decode(timed, lambda: serve._full(
                    args[-1]["tokens"]).cpu().numpy(), args)
            return decode

        timed_step = self._timed(real_step, self.decode_s,
                                 self.decode_logits)

        def slot_step(step, tok, pos):
            probe.in_step = True
            try:
                return probe._decode(timed_step, lambda: tok[:, None].copy(),
                                     (step, tok, pos))
            finally:
                probe.in_step = False

        step_lib.make_prefill_step = make_prefill
        step_lib.make_decode_step = make_decode
        serve._SlotStep.__call__ = slot_step
        store = model_registry.PagedStateStore
        store.gather_dense = lambda obj, *a: self._timed(
            lambda *x: real_g(obj, *x), self.gather_s, None)(*a)
        store.scatter_dense = lambda obj, *a: self._timed(
            lambda *x: real_s(obj, *x), self.scatter_s, None)(*a)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        (step_lib.make_prefill_step, step_lib.make_decode_step,
         model_registry.PagedStateStore.gather_dense,
         model_registry.PagedStateStore.scatter_dense,
         serve._SlotStep.__call__) = self.real


def med_ms(walls) -> float:
    return statistics.median(walls) * 1e3 if walls else float("nan")


def top2_margin(logits: torch.Tensor) -> float:
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def first_difference(a: np.ndarray, b: np.ndarray):
    """(row, step) of the first token where ``a`` and ``b`` differ, the
    earliest step first."""
    diff = np.argwhere(a != b)
    if not len(diff):
        return None
    r, t = min(map(tuple, diff), key=lambda rt: (rt[1], rt[0]))
    return int(r), int(t)


def serve_logits_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max |got - want| over max(1, max |want|): the CPU tests' measure."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    return float((g - w).abs().max()) / max(1.0, float(w.abs().max()))


def serve_inputs(cfg, batch: int, seq: int, seed: int, dtype) -> dict:
    rng = np.random.default_rng(seed)
    n = seq - cfg.n_vision_tokens if cfg.frontend == "vit_patches" else seq
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, n), dtype=np.int32))}
    if cfg.frontend == "vit_patches":
        out["patches"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.n_vision_tokens, model_tf.VIT_HIDDEN),
            dtype=np.float32)).to(dtype)
    if cfg.frontend == "audio_frames":
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, seq, model_tf.AUDIO_HIDDEN), dtype=np.float32)).to(dtype)
    return out


def on(tree, dev):
    return tree_map(lambda t: t.to(dev), tree)


def phase_serve_families(seed: int, dev) -> None:
    """Each family's smoke model in f32, the card against the CPU: prefill
    logits and the first decode step's from the same cache within the CPU
    tests' f32 bar; greedy tokens equal (or, where they differ, the CPU's
    top-2 margin at the first difference under the bar); hubert through
    the encode step. Then the reference's bit-equal properties on the
    card: a ragged row equals a solo run, slots equal batch, an evicted
    request equals an uncontended run, paged equals unpaged."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = torch.device("cpu")
    for arch in MODEL_FAMILY_ARCHS:
        cfg = smoke_config(arch)
        p_c = tree_map(lambda t: t.float(),
                       model_tf.init_params(cfg, seed=seed, device=cpu))
        p_d = on(p_c, dev)
        batch = serve_inputs(cfg, 2, 16 if arch == "hubert-xlarge" else 8,
                             seed, torch.float32)
        if arch == "hubert-xlarge":
            enc_c = step_lib.make_encode_step(cfg)(p_c, batch)
            enc_d = step_lib.make_encode_step(cfg)(p_d, on(batch, dev))
            err = serve_logits_err(enc_d, enc_c)
            print(f"serve/{arch} smoke f32 encode, card against CPU: "
                  f"logits {tuple(enc_d.shape)} err {err} of scale (bar "
                  f"{SERVE_F32_TOL})")
            assert err <= SERVE_F32_TOL, (arch, err)
            continue
        lg_c, c_c = step_lib.make_prefill_step(cfg)(p_c, batch)
        lg_d, _ = step_lib.make_prefill_step(cfg)(p_d, on(batch, dev))
        pre_err = serve_logits_err(lg_d, lg_c)
        total = batch["tokens"].shape[1] + 4 + cfg.n_vision_tokens
        c_c = serve.grow_cache(c_c, model_tf.abstract_cache(cfg, 2, total))
        tok = torch.argmax(lg_c, -1).to(torch.int32)[:, None]
        dbatch = {"tokens": tok, "pos": torch.tensor(total - 4,
                                                     dtype=torch.int32)}
        dl_c, _ = step_lib.make_decode_step(cfg, total)(p_c, c_c, dbatch)
        dl_d, _ = step_lib.make_decode_step(cfg, total)(
            p_d, on(c_c, dev), on(dbatch, dev))
        dec_err = serve_logits_err(dl_d, dl_c)
        line = (f"serve/{arch} smoke f32, card against CPU: prefill logits "
                f"err {pre_err}, first decode step {dec_err} of scale (bar "
                f"{SERVE_F32_TOL})")
        assert pre_err <= SERVE_F32_TOL and dec_err <= SERVE_F32_TOL, \
            (arch, pre_err, dec_err)
        if cfg.frontend == "vit_patches":
            print(line + "; generate needs no patches: not served whole")
            continue
        prompts = np.random.default_rng(seed + 1).integers(
            0, cfg.vocab, (3, 10), dtype=np.int32)
        with ServeProbe(arch, keep_all=True) as probe:
            out_c = serve.generate(cfg, p_c, prompts, max_new=8)
        out_d = serve.generate(cfg, p_d, prompts, max_new=8)
        first = first_difference(out_d, out_c)
        if first is None:
            print(line + f"; greedy tokens equal ({out_d.size} tokens)")
        else:
            r, t = first
            lg = probe.prefill_logits[0] if t == 0 \
                else probe.decode_logits[t - 1]
            margin = top2_margin(lg[r])
            scale = max(1.0, float(lg.abs().max()))
            print(line + f"; greedy tokens differ first at row {r} step "
                  f"{t}: the CPU's top-2 margin there {margin} "
                  f"({margin / scale} of scale, bar {SERVE_F32_TOL})")
            assert margin / scale <= SERVE_F32_TOL, (arch, margin, scale)

    cfg = smoke_config(SERVE_ARCH)
    p_d = on(tree_map(lambda t: t.float(),
                      model_tf.init_params(cfg, seed=seed, device=cpu)), dev)
    prompts = np.random.default_rng(seed + 2).integers(
        0, cfg.vocab, (4, 12), dtype=np.int32)
    lens = np.array([7, 12, 9, 11], np.int32)
    golden = serve.generate(cfg, p_d, prompts, max_new=8, prompt_lens=lens)
    solo = np.stack([serve.generate(cfg, p_d, prompts[i:i + 1, :n],
                                    max_new=8)[0]
                     for i, n in enumerate(lens)])
    slots = serve.generate(cfg, p_d, prompts, max_new=8, prompt_lens=lens,
                           stream="slots", slots=2)
    prios = np.array([1, 1, 0, 0], np.int32)
    evicted = serve.generate(cfg, p_d, prompts, max_new=8, prompt_lens=lens,
                             workers=2, slots=2, evict="priority",
                             priorities=prios)
    n_evict = serve._generate_fanin.last_stats["evictions"]
    paged = serve.generate(cfg, p_d, prompts, max_new=8, prompt_lens=lens,
                           workers=2, slots=2, evict="priority",
                           priorities=prios, paged=True, page_size=4)
    checks = {"ragged rows = solo runs": bool((golden == solo).all()),
              "slots = batch": bool((slots == golden).all()),
              "evicted = uncontended": bool((evicted == golden).all()),
              "paged = unpaged": bool((paged == evicted).all())}
    print(f"serve/{SERVE_ARCH} smoke f32 on the card, the reference's "
          f"properties: {json.dumps(checks)} ({n_evict} evictions)")
    assert all(checks.values()) and n_evict > 0, checks


def cache_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def serve_modes(page: int, prios: np.ndarray) -> list:
    fan = dict(workers=SERVE_WORKERS, slots=SERVE_SLOTS, evict="priority",
               priorities=prios)
    return [("batch bf16", dict(kv_storage="bf16")),
            ("batch int8", dict(kv_storage="int8")),
            ("batch f8", dict(kv_storage="f8")),
            ("slots bf16", dict(stream="slots", slots=SERVE_SLOTS)),
            ("slots int8", dict(stream="slots", slots=SERVE_SLOTS,
                                cache_transfer="int8")),
            ("fanin", fan),
            ("fanin paged", dict(fan, paged=True, page_size=page))]


def resident_bytes(cfg, kw: dict, stats: dict) -> tuple:
    """The cache's bytes as it is stored in this mode (for the paged table
    its fully backed pool), and of its scale leaves."""
    st = kw.get("kv_storage", "bf16")
    if kw.get("paged"):
        return stats["dense_hbm_bytes_per_slot"] * SERVE_SLOTS, 0
    rows = SERVE_SLOTS if "slots" in kw else SERVE_BATCH
    c = model_tf.abstract_cache(cfg, rows, SERVE_BUFFER + SERVE_NEW,
                                kv_storage=st)
    return (sum(l.nbytes for l in c.values()),
            sum(l.nbytes for k, l in c.items() if k.endswith("_scale")))


def check_published(cfg) -> None:
    """Granite-3-8B as published (src/repro/configs/granite_3_8b.py)."""
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.tie_embeddings) == \
        (40, 4096, 32, 8, 128, 12800, 49155, True), cfg


def phase_serve_full_width(args, dev, smi: str) -> None:
    """Granite-3-8B at full width in bf16, weights from ``init_params``
    drawn on the card: 8 requests of 512-2048 tokens in a 2048-token
    buffer, 64 new tokens greedy, through each serving mode, each timed
    end to end, with one decode step profiled; then the gates."""
    cfg = get_config(SERVE_ARCH)
    check_published(cfg)
    t0 = time.perf_counter()
    params = model_tf.init_params(cfg, seed=args.seed, device=dev,
                                  draw_on_device=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(args.seed)
    lens = rng.integers(SERVE_LEN_RANGE[0], SERVE_LEN_RANGE[1] + 1,
                        SERVE_BATCH).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab, (SERVE_BATCH, SERVE_BUFFER),
                           dtype=np.int32)
    prios = (np.arange(SERVE_BATCH) % SERVE_CLASSES).astype(np.int32)
    total = SERVE_BUFFER + SERVE_NEW
    swept = tuned_page_size(DECODE_32K_SEQ, batch=SERVE_BATCH,
                            heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                            head_dim=cfg.head_dim)
    print(f"serve/{SERVE_ARCH} bf16 full width ({cfg.n_layers} x "
          f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, "
          f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"tied; {n_params} parameters, {n_params * 2} bytes, drawn on the "
          f"card in {init_s} s; {smi}): {SERVE_BATCH} requests, lengths "
          f"{lens.tolist()} in a {SERVE_BUFFER}-token buffer, {SERVE_NEW} "
          f"new tokens greedy, horizon {total}; the paged_attn page phase "
          f"6's sweep left: {swept}")
    t0 = time.perf_counter()
    serve.generate(cfg, params, prompts[:2], max_new=2, prompt_lens=lens[:2])
    torch.cuda.synchronize()
    print(f"serve/{SERVE_ARCH} warm-up (2 requests, 2 new tokens, "
          f"untimed below): {time.perf_counter() - t0} s")
    outs, first_dec, first_pre, by_mode = {}, {}, {}, {}
    for mode, kw in serve_modes(swept, prios):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        label = f"serve/{SERVE_ARCH} {mode}"
        with ServeProbe(label, profile_call=SERVE_PROFILE_CALL) as probe:
            t0 = time.perf_counter()
            out = serve.generate(cfg, params, prompts, max_new=SERVE_NEW,
                                 prompt_lens=lens, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / (1 << 30)
        outs[mode] = out
        first_dec[mode] = probe.decode_logits[0]
        first_pre[mode] = probe.prefill_logits[0]
        stats = {}
        if "workers" in kw:
            stats = dict(serve._generate_fanin.last_stats)
        elif kw.get("stream") == "slots":
            stats = dict(serve._generate_slots.last_stats)
        by_mode[mode] = stats
        n_pre_tok = stats.get("admissions", SERVE_BATCH)
        dec_tok = out.size - n_pre_tok
        dec_s = sum(probe.decode_s)
        stored, scales = resident_bytes(cfg, kw, stats)
        paged = ""
        if probe.gather_s:
            paged = (f"; paged gather {med_ms(probe.gather_s)} ms, scatter "
                     f"{med_ms(probe.scatter_s)} ms a step (medians)")
        print(f"{label}: end to end {wall} s; prefill {len(probe.prefill_s)}"
              f" calls, the first {probe.prefill_s[0] * 1e3} ms, median "
              f"{med_ms(probe.prefill_s)} ms, time to the first token "
              f"{probe.ttft_s} s; decode {probe.n_decode} steps, "
              f"median {med_ms(probe.decode_s)} ms, {dec_tok / dec_s} decode"
              f" tokens/s; peak {peak} GiB; cache as stored {stored} bytes "
              f"({scales} of scales){paged}; stats {json.dumps(stats)}")
        assert probe.finite, (mode, "a logit is not finite")
        assert out.shape == (SERVE_BATCH, SERVE_NEW) and \
            ((out >= 0) & (out < cfg.vocab)).all(), mode
    # ---- gates ---------------------------------------------------------
    same = bool((outs["fanin paged"] == outs["fanin"]).all())
    print(f"serve/{SERVE_ARCH} paged fan-in tokens bit-equal to unpaged "
          f"fan-in: {same}")
    assert same
    for st, bar in STORAGE_BARS.items():
        err = serve_logits_err(first_dec[f"batch {st}"],
                               first_dec["batch bf16"])
        print(f"serve/{SERVE_ARCH} {st} storage, first decode step's logits "
              f"against bf16: {err} of scale (bar {bar})")
        assert err <= bar, (st, err)
    b16, _ = resident_bytes(cfg, {"kv_storage": "bf16"}, {})
    i8, i8s = resident_bytes(cfg, {"kv_storage": "int8"}, {})
    f8, _ = resident_bytes(cfg, {"kv_storage": "f8"}, {})
    print(f"serve/{SERVE_ARCH} cache bytes at {SERVE_BATCH} x {total}: "
          f"bf16 {b16}, int8 {i8} ({i8s} of scales), f8 {f8}")
    assert i8 - i8s == b16 // 2 and i8 < b16 and f8 * 2 == b16
    print(f"serve/{SERVE_ARCH} contended fan-in evictions: "
          f"{by_mode['fanin']['evictions']} unpaged, "
          f"{by_mode['fanin paged']['evictions']} paged")
    assert by_mode["fanin"]["evictions"] > 0
    # each ragged row's prefill logits against a solo prefill of its prompt
    prefill = step_lib.make_prefill_step(cfg)
    worst = 0.0
    for i, n in enumerate(lens):
        lg, _ = prefill(params, {"tokens": torch.from_numpy(
            prompts[i:i + 1, :n]).to(dev)})
        worst = max(worst, row_rel_err(first_pre["batch bf16"][i][None],
                                       lg.float().cpu()))
    print(f"serve/{SERVE_ARCH} ragged rows' prefill logits against solo "
          f"prefills: worst {worst} of the row's scale (bar "
          f"{ROW_REL_BAR[torch.bfloat16]})")
    assert worst <= ROW_REL_BAR[torch.bfloat16], worst
    base = outs["batch bf16"]
    agree = {m: float((o == base).all(axis=1).mean()) for m, o in outs.items()}
    print(f"serve/{SERVE_ARCH} rows whose tokens equal batch bf16's "
          f"(printed, not gated: the modes run other shapes): "
          f"{json.dumps(agree)}")
    del params


def phase_serve_f8(dev) -> None:
    """``cast_f8`` over all 65,536 bf16 bit patterns, card against CPU."""
    pats = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    x = pats.view(torch.bfloat16)
    got = coll.cast_f8(x.to(dev)).cpu()
    want = coll.cast_f8(x)
    same = same_bits(got, want)
    print(f"serve/cast_f8 over all 65536 bf16 patterns, card against CPU: "
          f"bytes equal {same}")
    assert same


def phase_serve(args, dev, smi: str) -> None:
    """Phase 11: serving on the card. No registry kernel lies on this
    path (the reference's model calls none), so every launch count stays
    0."""
    walls = {}
    kern.reset_launches()
    reset_sweep_launches()
    for part, fn in (("families", lambda: phase_serve_families(args.seed, dev)),
                     ("full width", lambda: phase_serve_full_width(args, dev,
                                                                   smi)),
                     ("cast_f8", lambda: phase_serve_f8(dev))):
        t0 = time.perf_counter()
        fn()
        walls[part] = time.perf_counter() - t0
    launches = {**dict(kern.LAUNCHES), **sweep_launches()}
    print(f"serve: launches {json.dumps(launches)} (no kernel on the path); "
          f"phase wall {sum(walls.values())} s, by part (s) "
          f"{json.dumps(walls)}")
    assert not any(launches.values()), launches


# ------------------------------------------------------------ train/ranks
# Phase 12: training across W ranks, spawned once. With a card for each
# rank they talk over NCCL; on one card the ranks share cuda:0 over gloo,
# since NCCL refuses two ranks on one device. Its numbers are the card's:
# 4 processes sharing one H100, not a multi-card figure.
RANKS_W = 4
RANKS_PLAN = {
    # (a) the two-stage int8 psum at paper-lm-100m's largest gradient
    # leaf, the tied embedding (vocab 32000 x d_model 768)
    "psum_shape": (32000, 768),
    # (b) the data-parallel step, paper-lm-100m at full width, all 12
    # layers: global batch 8 x 4096 (2 rows a rank), 5 steps a transport
    "dp_arch": MODEL_ARCH, "dp_batch": 8, "dp_seq": 4096, "dp_steps": 5,
    # (c) the SPMD step under baseline on (data 2, model 2): Granite-3-8B
    # at full width, depth cut to 4 of 40 layers, batch to 2 x 2048
    "spmd_arch": "granite-3-8b", "spmd_layers": 4, "spmd_model": 2,
    "spmd_batch": 2, "spmd_seq": 2048, "spmd_steps": 3,
    # (d) the launcher's wiring at its defaults, cut to fit phases 12 and
    # 13 in one command (on an NVIDIA H100 80GB HBM3 at 700 W a step
    # across 4 ranks sharing the card took 6.7-9.0 s, against 0.3 s in
    # one process): 4 of its 60 steps (6 until phase 13 came), an
    # AutoComp cycle every 3 steps instead of 25 and a checkpoint every 2
    # instead of 20; then steps 2-3 again from the step-2 checkpoint
    # restored with shardings=
    "launch_argv": ["--steps", "4", "--compact-every", "3"],
    "launch_ckpt_every": 2, "launch_restore": 2,
    "smoke": False, "device": "cuda",
    # phase 13, serving across the same ranks (SERVE_RANKS_PLAN below)
    "serve": None,
}
RANKS_ADAMW = {"lr": 1e-3, "warmup_steps": 10, "total_steps": 60}
# Each arm's step against one process on the same batches, beyond the
# loss: every step's grad_norm (relative), which a step that skips the
# reduction (about 1/W) or sums where it should average (W times)
# misses by tens of percent; and the parameters after the last step,
# |final - one process's final| / |one process's update| over every
# parameter, which is 1 for a step that skips the update. The sound arms
# read at most 1.8e-3 and 0.057 on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md, Findings): the reductions regroup bf16 sums, and
# int8_ef is held against one process's bf16 step.
RANKS_NORM_BAR, RANKS_GAP_BAR = 1e-2, 0.25


def ranks_config(plan: dict, arch: str, n_layers: Optional[int] = None):
    cfg = smoke_config(arch) if plan["smoke"] else get_config(arch)
    return cfg if n_layers is None else \
        dataclasses.replace(cfg, n_layers=n_layers)


def ranks_batches(vocab: int, steps: int, rows: int, seq: int, seed: int
                  ) -> list:
    """``steps`` global batches of ``rows`` x ``seq`` tokens from ``seed``
    (numpy, the same in every process)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        tok = rng.integers(0, vocab, (rows, seq + 1), dtype=np.int32)
        out.append({"tokens": torch.from_numpy(tok[:, :-1].copy()),
                    "labels": torch.from_numpy(tok[:, 1:].copy())})
    return out


def timed_steps(step_fn, params, opt, batches, dev):
    """``step_fn`` over ``batches``: the final parameters and state, and
    the run: each step's loss, grad_norm, ms (synchronised) and wire
    bytes by kind."""
    run = {"losses": [], "norms": [], "ms": [], "wire": []}
    for nb in batches:
        nb = {k: v.to(dev) for k, v in nb.items()}
        coll.reset_wire_bytes()
        sync(dev)
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, nb)
        run["losses"].append(float(m["loss"]))
        run["norms"].append(float(m["grad_norm"]))
        sync(dev)
        run["ms"].append((time.perf_counter() - t0) * 1e3)
        run["wire"].append(coll.wire_bytes())
    return params, opt, run


def one_process(cfg, batches, dev, seed: int, save_to: str) -> dict:
    """The one-device step over the same global batches, from the same
    weights (drawn on ``dev`` from ``seed``): its run, and its final
    parameters saved to ``save_to`` for the ranks' :func:`param_gap`."""
    params = model_tf.init_params(cfg, seed=seed, device=dev,
                                  draw_on_device=True)
    step_fn = step_lib.make_train_step(cfg, opt_lib.AdamWConfig(**RANKS_ADAMW))
    params, _, run = timed_steps(step_fn, params,
                                 opt_lib.init_state(params), batches, dev)
    torch.save([p.cpu() for p in tree_leaves(params)], save_to)
    return run


def param_gap(final, init, ref_path: str, dev) -> float:
    """``|final - ref| / |ref - init|`` over every parameter (f32 sums of
    squares), ``ref`` the one-process final parameters at ``ref_path``:
    0 for the same step, 1 for a step that skips the update. A DTensor
    leaf is gathered whole, a collective that every rank joins."""
    from repro_torch.dist import sharding as shd

    def whole(t):
        return (t.full_tensor() if shd.is_dtensor(t) else t).float()

    gap = upd = 0.0
    for f, i, w in zip(tree_leaves(final), tree_leaves(init),
                       torch.load(ref_path, mmap=True)):
        w = w.to(dev).float()
        gap += float(((whole(f) - w) ** 2).sum())
        upd += float(((w - whole(i)) ** 2).sum())
    return math.sqrt(gap / upd)


def ranks_psum(plan: dict, rank: int, world: int, mesh, dev,
               seed: int) -> dict:
    """(a) ``compressed_psum`` over the data axis on every rank against the
    plain one-process emulation of the same exchange, bit for bit."""
    shape = plan["psum_shape"]
    carries = []
    for r in range(world):
        gen = torch.Generator(dev).manual_seed(seed * 1000 + r)
        x = torch.randn(shape, generator=gen, device=dev) \
            * torch.exp(torch.randn(shape, generator=gen, device=dev))
        carries.append((x, torch.randn(shape, generator=gen, device=dev)
                        * 1e-2))
    x, err = carries[rank]
    ms = []
    for _ in range(3):
        coll.reset_wire_bytes()
        sync(dev)
        t0 = time.perf_counter()
        out, new_err = coll.compressed_psum(x, "data", err, mesh=mesh)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    wire = coll.wire_bytes()
    want, want_err = coll.two_stage_int8_psum_plain(torch.stack(
        [(a + e).reshape(-1) for a, e in carries]))
    same = same_bits(out.reshape(-1), want) and \
        same_bits(new_err.reshape(-1), want_err[rank])
    return {"same": same, "ms": ms, "wire": wire}


def ranks_dp(plan: dict, mesh, dev, seed: int) -> dict:
    """(b) the data-parallel step, both transports, on the same batches,
    each arm's final parameters held against one process's."""
    cfg = ranks_config(plan, plan["dp_arch"])
    batches = ranks_batches(cfg.vocab, plan["dp_steps"], plan["dp_batch"],
                            plan["dp_seq"], seed)
    params = model_tf.init_params(cfg, seed=seed, device=dev,
                                  draw_on_device=True)
    adamw = opt_lib.AdamWConfig(**RANKS_ADAMW)
    out = {}
    for transport in step_lib.GRAD_TRANSPORTS:
        step_fn = step_lib.make_train_step(cfg, adamw,
                                           grad_transport=transport,
                                           mesh=mesh)
        opt = opt_lib.init_state(params,
                                 error_feedback=transport == "int8_ef",
                                 ef_devices=1)
        final, opt, run = timed_steps(step_fn, params, opt, batches, dev)
        run["wire"] = run["wire"][-1]
        run["gap"] = param_gap(final, params, plan["dp_ref"], dev)
        out[transport] = run
        if transport == "int8_ef":
            run["ef_nonzero"] = all(
                bool((e != 0).any()) for e in tree_leaves(opt["ef"]))
        del opt, final
    return out


def _walk(tree, prefix=()):
    """``(path, leaf)`` pairs in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _walk(t, prefix + (i,))
    else:
        yield prefix, tree


def ranks_spmd(plan: dict, dev, seed: int) -> dict:
    """(c) the SPMD step under baseline on (data 2, model 2): each leaf's
    local shard shape against ``resolve_spec``'s, the run, and the final
    parameters held against one process's."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import mesh as mesh_lib

    cfg = ranks_config(plan, plan["spmd_arch"], plan["spmd_layers"])
    mesh = mesh_lib.make_local_mesh(plan["spmd_model"], device=dev)
    rules = shd.PRESETS["baseline"]
    axes = model_tf.param_axes(cfg)
    params = shd.distribute_tree(
        model_tf.init_params(cfg, seed=seed, device=dev, draw_on_device=True),
        axes, mesh, rules)
    shapes = {}
    for (path, leaf), ax in zip(_walk(params),
                                tree_leaves(axes, model_tf.is_axes)):
        spec = shd.resolve_spec(leaf.shape, ax, mesh, rules)
        shapes["/".join(map(str, path))] = (
            tuple(leaf.to_local().shape),
            shd.local_shape(leaf.shape, spec, mesh), spec)
    with shd.axis_rules(mesh, rules):
        step_fn = step_lib.make_train_step(
            cfg, opt_lib.AdamWConfig(**RANKS_ADAMW))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    final, opt, run = timed_steps(
        step_fn, params, opt_lib.init_state(params),
        ranks_batches(cfg.vocab, plan["spmd_steps"], plan["spmd_batch"],
                      plan["spmd_seq"], seed), dev)
    run["peak_gib"] = torch.cuda.max_memory_allocated(dev) / (1 << 30) \
        if dev.type == "cuda" else None
    del opt
    run["gap"] = param_gap(final, params, plan["spmd_ref"], dev)
    run["shapes"] = shapes
    return run


def skip_batches(factory, n: int):
    """``factory``'s batches after its first ``n``: the stream a run
    restored at step ``n`` would have gone on reading."""
    def gen():
        it = factory()
        for _ in range(n):
            next(it)
        yield from it
    return gen


def run_launcher(plan: dict) -> tuple:
    """``launch.train.build`` at ``plan``'s arguments, run as ``main`` runs
    it, with the plan's checkpoint interval: the wiring and the
    history."""
    run = launch_train.build(launch_train.parse_args(plan["launch_argv"]))
    run.trainer.cfg.ckpt_every = plan["launch_ckpt_every"]
    return run, run.trainer.run_with_recovery()["history"]


def ranks_launch(plan: dict, rank: int, dev) -> dict:
    """(d) the launcher across the ranks: run 1, an elastic restore of the
    last checkpoint with ``shardings=`` held against the live state, then
    the steps after an earlier checkpoint again from it, restored with
    ``shardings=``, on the batches run 1 read there."""
    from repro_torch.dist import sharding as shd

    check = MergeCheck(packing.merge_shards_fn)
    launch_train.merge_shards_fn = check
    kern.reset_launches()
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            run, hist = run_launcher(plan)
        sync(dev)
    finally:
        launch_train.merge_shards_fn = packing.merge_shards_fn
    chunks = kern.LAUNCHES["compact_chunks"]
    merged = check.verify(drop_rows=None) if rank == 0 else None
    tr = run.trainer
    rules = shd.PRESETS["baseline"]
    axes = model_tf.param_axes(run.cfg)
    shardings = (shd.tree_shardings(tr.params, axes, run.mesh, rules),
                 shd.tree_shardings(tr.opt_state, opt_lib.state_axes(axes),
                                    run.mesh, rules),
                 None)
    like = (tr.params, tr.opt_state, 0)
    (p_last, o_last, _), last = tr.ckpt.restore(like, shardings=shardings)
    live = tree_leaves((tr.params, tr.opt_state["mu"], tr.opt_state["nu"]))
    got = tree_leaves((p_last, o_last["mu"], o_last["nu"]))
    same_last = all(same_bits(a.full_tensor(), b.full_tensor())
                    for a, b in zip(got, live))
    placed = all(tuple(a.placements) == tuple(b.placements)
                 for a, b in zip(got, live))
    (p_at, o_at, s_at), restored = tr.ckpt.restore(
        like, step=plan["launch_restore"], shardings=shardings)
    del run, tr, like, live, got, p_last, o_last
    run2 = launch_train.build(launch_train.parse_args(plan["launch_argv"]))
    tr2 = run2.trainer
    tr2.params, tr2.opt_state, tr2.step, tr2.ckpt = p_at, o_at, int(s_at), \
        None
    tr2.batches = skip_batches(tr2.batches, int(s_at))
    after = tr2.run()["history"]
    return {"text": text.getvalue(), "losses": [h["loss"] for h in hist],
            "ms": [h["time_s"] * 1e3 for h in hist], "chunks": chunks,
            "merged": merged, "last": last, "same_last": same_last,
            "placed": placed, "restored": restored,
            "after": [(h["step"], h["loss"]) for h in after]}


def ranks_rank(rank: int, world: int, init: str, backend: str, plan: dict,
               seed: int) -> dict:
    """One rank of phase 12: (a)-(d) in order, on this rank's device."""
    from repro_torch.launch import mesh as mesh_lib

    dev = mesh_lib.init_ranks(backend, rank=rank, world_size=world,
                              init_method=init, device=plan["device"])
    staged = list(coll.GLOO_HOST_STAGED) if coll._staging else []
    mesh = mesh_lib.make_local_mesh(device=dev)
    out = {"device": str(dev), "staged": staged, "walls": {}}
    parts = (("psum", lambda: ranks_psum(plan, rank, world, mesh, dev, seed)),
             ("dp", lambda: ranks_dp(plan, mesh, dev, seed)),
             ("spmd", lambda: ranks_spmd(plan, dev, seed)),
             ("launch", lambda: ranks_launch(plan, rank, dev)))
    if plan.get("serve"):
        parts += (("serve", lambda: ranks_serve(plan, rank, dev, seed)),)
    for part, fn in parts:
        t0 = time.perf_counter()
        out[part] = fn()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["walls"][part] = time.perf_counter() - t0
        if rank == 0:
            print(f"train/ranks rank 0: {part} done in "
                  f"{out['walls'][part]} s", flush=True)
    return out


def nccl_rank(rank: int, world: int, init: str, plan: dict,
              seed: int) -> dict:
    """One NCCL rank at world 1 on cuda:0: the (1, 1) DeviceMesh, the
    parameters laid out on it and gathered back, the data-parallel step
    under ``int8_ef`` (the two-stage exchange over NCCL) on the
    data-parallel arm's global batches."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import mesh as mesh_lib

    dev = mesh_lib.init_ranks("nccl", rank=rank, world_size=world,
                              init_method=init)
    mesh = mesh_lib.make_local_mesh(device=dev)
    cfg = ranks_config(plan, plan["dp_arch"])
    params = model_tf.init_params(cfg, seed=seed, device=dev,
                                  draw_on_device=True)
    placed = shd.distribute_tree(params, model_tf.param_axes(cfg), mesh,
                                 shd.PRESETS["baseline"])
    round_trip = all(same_bits(a.full_tensor(), b) for a, b in
                     zip(tree_leaves(placed), tree_leaves(params)))
    del placed
    step_fn = step_lib.make_train_step(
        cfg, opt_lib.AdamWConfig(**RANKS_ADAMW), grad_transport="int8_ef",
        mesh=mesh)
    _, _, run = timed_steps(
        step_fn, params, opt_lib.init_state(params, error_feedback=True,
                                            ef_devices=1),
        ranks_batches(cfg.vocab, 2, plan["dp_batch"], plan["dp_seq"], seed),
        dev)
    return {**run, "mesh": str(mesh), "round_trip": round_trip,
            "wire": run["wire"][-1]}


def worst_rel(got, want) -> float:
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def phase_ranks(args, dev, smi: str, plan: Optional[dict] = None) -> tuple:
    """Phases 12 and 13: training, then serving, across one group of
    ranks. Returns ``compact_chunks``'s launches on the launcher's run
    across the ranks (the ``train@4`` path) and the kernels' launches on
    the ``serve@4`` path (``None`` without a serve plan)."""
    from repro_torch.dist.spawn import run_ranks
    from repro_torch.launch.mesh import pick_backend

    plan = RANKS_PLAN if plan is None else plan
    t_phase = time.perf_counter()
    bar = ROW_REL_BAR[torch.bfloat16]
    backend = pick_backend(plan["device"], RANKS_W)
    where = "a card each" if backend == "nccl" else \
        f"sharing {dev} ({torch.cuda.device_count()} card(s))"
    print(f"train/ranks ({smi}): {RANKS_W} ranks over {backend}, {where}; "
          f"the backend chosen by the card count, before any collective")
    print(f"train/ranks reduced: " + json.dumps({
        "spmd depth (granite-3-8b: 40)": plan["spmd_layers"],
        "spmd batch": f"{plan['spmd_batch']} x {plan['spmd_seq']}",
        "launcher (its defaults: 60 steps, a cycle every 25, a checkpoint "
        "every 20)": [plan["launch_argv"],
                      f"ckpt every {plan['launch_ckpt_every']}"]}))
    # the one-process references, before the ranks take the card; their
    # final parameters go to files the ranks read
    refs = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        plan = dict(plan, dp_ref=os.path.join(refs, "dp.pt"),
                    spmd_ref=os.path.join(refs, "spmd.pt"))
        cfg = ranks_config(plan, plan["dp_arch"])
        dp_one = one_process(cfg, ranks_batches(
            cfg.vocab, plan["dp_steps"], plan["dp_batch"], plan["dp_seq"],
            args.seed), dev, args.seed, plan["dp_ref"])
        scfg = ranks_config(plan, plan["spmd_arch"], plan["spmd_layers"])
        spmd_one = one_process(scfg, ranks_batches(
            scfg.vocab, plan["spmd_steps"], plan["spmd_batch"],
            plan["spmd_seq"], args.seed), dev, args.seed, plan["spmd_ref"])
        with contextlib.redirect_stdout(io.StringIO()):
            ref_hist = run_launcher(plan)[1]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = run_ranks(ranks_rank, RANKS_W, backend, plan, args.seed,
                        timeout=600)
    finally:
        shutil.rmtree(refs, ignore_errors=True)
    dp_ref, spmd_ref = dp_one["losses"], spmd_one["losses"]
    print(f"train/ranks group: {time.perf_counter() - t0} s for {RANKS_W} "
          f"spawned ranks on {[r['device'] for r in res]}; collectives "
          f"staged through pinned host buffers: {res[0]['staged'] or 'none'}"
          f"; per-rank part walls (s) {[r['walls'] for r in res]}")
    # (a)
    ps = [r["psum"] for r in res]
    print(f"train/ranks psum {plan['psum_shape']} f32 over data={RANKS_W}: "
          f"outputs and residuals bit-equal to the one-process emulation "
          f"{[p['same'] for p in ps]}; ms per rank (3 calls) "
          f"{[p['ms'] for p in ps]}; wire bytes per rank {ps[0]['wire']}")
    assert all(p["same"] for p in ps)
    # (b)
    wire = {}
    for transport in step_lib.GRAD_TRANSPORTS:
        arm = [r["dp"][transport] for r in res]
        wire[transport] = sum(arm[0]["wire"].values())
        rel = worst_rel(arm[0]["losses"], dp_ref)
        norm_rel = worst_rel(arm[0]["norms"], dp_one["norms"])
        print(f"train/ranks dp {cfg.name} bf16 {plan['dp_batch']} x "
              f"{plan['dp_seq']} ({plan['dp_batch'] // RANKS_W} rows a "
              f"rank), {transport}: step ms per rank (median of steps 2-"
              f"{plan['dp_steps']}) "
              f"{[statistics.median(a['ms'][1:]) for a in arm]}, all "
              f"{[a['ms'] for a in arm]}; wire bytes per step per rank "
              f"{arm[0]['wire']} (total {wire[transport]}); loss "
              f"{arm[0]['losses']} against one process {dp_ref} (its step "
              f"ms {dp_one['ms']}), worst rel {rel} (bar {bar}); grad_norm "
              f"{arm[0]['norms']} against {dp_one['norms']}, worst rel "
              f"{norm_rel} (bar {RANKS_NORM_BAR}); parameter gap "
              f"per rank {[a['gap'] for a in arm]} (bar "
              f"{RANKS_GAP_BAR})")
        assert all(a["losses"] == arm[0]["losses"] for a in arm)
        assert rel <= bar, rel
        assert norm_rel <= RANKS_NORM_BAR, norm_rel
        assert all(a["gap"] <= RANKS_GAP_BAR for a in arm)
    assert all(r["dp"]["int8_ef"]["ef_nonzero"] for r in res)
    print(f"train/ranks dp wire: int8_ef {wire['int8_ef']} bytes a step "
          f"against bf16 {wire['bf16']} ({wire['bf16'] / wire['int8_ef']}x)")
    assert wire["int8_ef"] < wire["bf16"], wire
    # (c)
    sp = [r["spmd"] for r in res]
    bad = [(k, v) for s in sp for k, v in s["shapes"].items()
           if v[0] != v[1]]
    rel = worst_rel(sp[0]["losses"], spmd_ref)
    norm_rel = worst_rel(sp[0]["norms"], spmd_one["norms"])
    print(f"train/ranks spmd {scfg.name} bf16 at full width, depth "
          f"{scfg.n_layers}, {plan['spmd_batch']} x {plan['spmd_seq']} "
          f"under baseline on (data, model) ({RANKS_W // plan['spmd_model']}"
          f", {plan['spmd_model']}): local shard shapes equal to "
          f"resolve_spec's {not bad} (rank 0: embed {sp[0]['shapes']['embed']}"
          f", wq {sp[0]['shapes']['layers/attn/wq']}); step ms per rank "
          f"{[s['ms'] for s in sp]}; peak GiB per rank "
          f"{[s['peak_gib'] for s in sp]}; loss {sp[0]['losses']} against "
          f"one process {spmd_ref} (its step ms {spmd_one['ms']}), worst rel "
          f"{rel} (bar {bar}); grad_norm {sp[0]['norms']} against "
          f"{spmd_one['norms']}, worst rel {norm_rel} (bar "
          f"{RANKS_NORM_BAR}); parameter gap per rank "
          f"{[s['gap'] for s in sp]} (bar {RANKS_GAP_BAR})")
    assert not bad, bad[:4]
    assert all(s["losses"] == sp[0]["losses"] for s in sp)
    assert rel <= bar, rel
    assert norm_rel <= RANKS_NORM_BAR, norm_rel
    assert all(s["gap"] <= RANKS_GAP_BAR for s in sp)
    # (d)
    ln = [r["launch"] for r in res]
    runs = dict(ln[0]["after"])
    mean1 = statistics.fmean(ln[0]["losses"][s] for s in runs)
    mean_rel = abs(statistics.fmean(runs.values()) - mean1) / mean1
    step_rel = worst_rel(list(runs.values()),
                         [ln[0]["losses"][s] for s in runs])
    n_cycles = ln[0]["text"].count("[autocomp] cycle")
    print(f"train/ranks launch: build({plan['launch_argv']}), a checkpoint "
          f"every {plan['launch_ckpt_every']} steps, across {RANKS_W} ranks"
          f", rank 0 printed:\n{ln[0]['text'].rstrip()}")
    print(f"train/ranks launch: step ms per rank (median of steps 2-) "
          f"{[statistics.median(l['ms'][1:]) for l in ln]}; loss "
          f"{ln[0]['losses'][0]} -> {ln[0]['losses'][-1]} against one "
          f"process {ref_hist[0]['loss']} -> {ref_hist[-1]['loss']} (worst "
          f"rel {worst_rel(ln[0]['losses'], [h['loss'] for h in ref_hist])}"
          f"); compact_chunks launches per rank {[l['chunks'] for l in ln]}"
          f"; merges checked {ln[0]['merged']}; [autocomp] lines "
          f"{n_cycles}; restore of step {ln[0]['last']} with shardings= "
          f"bit-equal {[l['same_last'] for l in ln]}, placements kept "
          f"{[l['placed'] for l in ln]}; steps {min(runs)}-{max(runs)} "
          f"again from step {ln[0]['restored']} on run 1's batches: mean "
          f"loss rel diff {mean_rel}, worst step {step_rel} (bar {bar})")
    assert n_cycles == 1 and not any(l["text"] for l in ln[1:])
    assert not any(l["chunks"] for l in ln[1:])
    assert ln[0]["chunks"] >= 1 or plan["device"] == "cpu"
    assert ln[0]["merged"]["compactions"] >= 1
    assert all(l["same_last"] and l["placed"] for l in ln)
    assert ln[0]["restored"] == plan["launch_restore"]
    assert mean_rel <= bar, mean_rel
    assert worst_rel(ln[0]["losses"], [h["loss"] for h in ref_hist]) <= bar
    assert ln[0]["losses"][-1] < ln[0]["losses"][0]
    # one NCCL rank at world 1, on the card only
    if plan["device"] == "cuda":
        t0 = time.perf_counter()
        nc = run_ranks(nccl_rank, 1, plan, args.seed, timeout=300)[0]
        rel = worst_rel(nc["losses"], dp_ref[:2])
        norm_rel = worst_rel(nc["norms"], dp_one["norms"][:2])
        print(f"train/ranks nccl world 1: {nc['mesh']}; parameters laid out "
              f"and gathered back bit-equal {nc['round_trip']}; dp "
              f"{cfg.name} int8_ef {plan['dp_batch']} x {plan['dp_seq']} "
              f"step ms {nc['ms']}, wire bytes {nc['wire']}, loss "
              f"{nc['losses']} against one process {dp_ref[:2]}, worst rel "
              f"{rel} (bar {bar}); grad_norm worst rel {norm_rel} (bar "
              f"{RANKS_NORM_BAR}); {time.perf_counter() - t0} s")
        assert nc["round_trip"] and rel <= bar, rel
        assert norm_rel <= RANKS_NORM_BAR, norm_rel
    print(f"train/ranks: phase wall {time.perf_counter() - t_phase} s")
    serve_launches = None
    if plan.get("serve"):
        serve_launches = report_serve_ranks(res, plan, args, smi)
    return ln[0]["chunks"], serve_launches


# ------------------------------------------------------------ serve/ranks
# Phase 13: serving across the same W ranks, run inside phase 12's group
# after its parts free their memory (one start-up of the processes and
# their CUDA contexts). On one card the ranks share it over gloo, as in
# phase 12: the numbers are 4 processes on one H100, not a multi-card
# figure.
SERVE_RANKS_PLAN = {
    # (a)-(c) Granite-3-8B at full width, depth cut to 4 of 40 layers;
    # phase 11's traffic: requests of 512-2048 tokens from --seed in a
    # 2048-token buffer, cut to 16 new greedy tokens (phase 11: 64)
    "arch": SERVE_ARCH, "layers": 4, "batch": SERVE_BATCH,
    "buffer": SERVE_BUFFER, "len_range": SERVE_LEN_RANGE, "new": 16,
    "slots": SERVE_SLOTS, "workers": SERVE_WORKERS,
    "classes": SERVE_CLASSES,
    # (d) Qwen3-MoE-30B-A3B at full width, depth cut to 2 of 48 layers
    # (every rank holds the whole model before keeping its shard: 1.2 GB
    # of experts a layer), 4 requests of 512 tokens, 8 new
    "moe_arch": "qwen3-moe-30b-a3b", "moe_layers": 2, "moe_batch": 4,
    "moe_len": 512, "moe_new": 8,
    # (e) each decoding family's smoke config in f32 (internvl2 needs
    # image patches, hubert has no decode: neither is served whole)
    "families": ("granite-3-8b", "qwen3-moe-30b-a3b", "minicpm3-4b",
                 "hymba-1.5b", "xlstm-125m"),
    "family_batch": 2, "family_len": 10, "family_new": 6,
    # the report's pricing, an NVIDIA H100 SXM's: NVLink 4 at 450 GB/s a
    # direction (the ranks here share one card and cross no link), HBM3
    "ici_bw": 450e9, "hbm_bw": HBM_BYTES_PER_S,
}


def serve_ranks_arms(meshes: dict, sp: dict, prios: np.ndarray) -> list:
    """(name, generate kwargs, the kwargs of its one-process reference)."""
    colo, pre, dec, pres, fdec = (meshes[k] for k in
                                  ("colo", "pre", "dec", "pres", "fdec"))
    dis = dict(mesh=pre, decode_mesh=dec)
    fan = dict(workers=sp["workers"], slots=sp["slots"], evict="priority",
               priorities=prios)
    return [
        ("colocated bf16", dict(mesh=colo), {}),
        ("colocated int8", dict(mesh=colo, act_transport="int8"),
         dict(act_transport="int8")),
        ("disagg bf16xbf16", dis, {}),
        ("disagg int8xbf16", dict(dis, cache_transfer="int8"), {}),
        ("disagg int8xint8", dict(dis, cache_transfer="int8",
                                  kv_storage="int8"), {}),
        ("disagg bf16xf8", dict(dis, kv_storage="f8"), {}),
        ("slots bf16", dict(dis, stream="slots", slots=sp["slots"]),
         dict(stream="slots", slots=sp["slots"])),
        ("fanin", dict(fan, mesh=pres[0], prefill_meshes=pres,
                       decode_mesh=fdec), fan),
    ]


def stored_bytes(cfg, kw: dict, rows: int, total: int) -> int:
    """This rank's bytes of the decode-side cache as stored: each leaf's
    bytes over its shard count on the decode mesh (0 off it)."""
    from repro_torch.dist import sharding as shd

    mesh = kw.get("decode_mesh", kw.get("mesh"))
    if shd.is_device_mesh(mesh) and mesh.get_coordinate() is None:
        return 0
    rules = shd.PRESETS["serve_decode"] if "decode_mesh" in kw \
        else shd.PRESETS["serve_sp"]
    st = kw.get("kv_storage", "bf16")
    n = 0
    for leaf, la in zip(
            tree_leaves(model_tf.abstract_cache(cfg, rows, total,
                                                kv_storage=st),
                        is_leaf=model_tf.is_tensor_spec),
            tree_leaves(model_tf.cache_axes(cfg, rows, total, kv_storage=st),
                        is_leaf=model_tf.is_axes)):
        spec = shd.resolve_spec(leaf.shape, tuple(la), mesh, rules)
        n += leaf.nbytes // shd.spec_shard_count(spec, mesh)
    return n


def serve_ranks_run(label: str, fn, dev) -> tuple:
    """``fn()`` under a :class:`ServeProbe`: its output and the arm's
    numbers on this rank."""
    coll.reset_wire_bytes()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with ServeProbe(label) as probe:
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        wall = time.perf_counter() - t0
    return out, {
        "wall_s": wall, "ttft_s": probe.ttft_s, "n_decode": probe.n_decode,
        "decode_ms": med_ms(probe.decode_s),
        "prefill_ms": med_ms(probe.prefill_s),
        "peak_gib": torch.cuda.max_memory_allocated(dev) / (1 << 30)
        if dev.type == "cuda" else float("nan"),
        "wire": coll.wire_bytes(), "finite": probe.finite,
        "first_decode": probe.decode_logits[0].numpy()
        if probe.decode_logits else None,
        "first_decode_tokens": probe.first_decode_tokens,
        "first_prefill": probe.prefill_logits[0].numpy()
        if probe.prefill_logits else None}


def ranks_serve(plan: dict, rank: int, dev, seed: int) -> dict:
    """Phase 13 on one rank: (a)-(c) Granite-3-8B over the meshes, (d)
    the MoE under ``ep``, (e) the smoke families, the disaggregated
    report; rank 0 also runs each arm's one-process reference on its
    device (the other ranks wait in their next collective)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels.expert_a2a import ops as a2a_ops
    from repro_torch.launch import mesh as mesh_lib

    sp = plan["serve"]
    kern.reset_launches()
    reset_sweep_launches()
    out = {"arms": {}, "ref": {}}
    cfg = ranks_config(plan, sp["arch"], sp["layers"])
    params = model_tf.init_params(cfg, seed=seed, device=dev,
                                  draw_on_device=dev.type == "cuda")
    rng = np.random.default_rng(seed)
    lens = rng.integers(sp["len_range"][0], sp["len_range"][1] + 1,
                        sp["batch"]).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab, (sp["batch"], sp["buffer"]),
                           dtype=np.int32)
    prios = (np.arange(sp["batch"]) % sp["classes"]).astype(np.int32)
    colo = mesh_lib.make_local_mesh(model_parallel=2, device=dev)
    pre, dec = serve.make_disagg_meshes(cfg, device=dev)
    pres, fdec = serve.make_fanin_meshes(cfg, sp["workers"], device=dev)
    meshes = dict(colo=colo, pre=pre, dec=dec, pres=pres, fdec=fdec)
    out["meshes"] = {k: (serve.mesh_ranks(v) if not isinstance(v, list)
                         else [serve.mesh_ranks(m) for m in v])
                     for k, v in meshes.items()}
    total = sp["buffer"] + sp["new"]
    gen_kw = dict(max_new=sp["new"], prompt_lens=lens)
    serve.generate(cfg, params, prompts[:2, :64], max_new=2,
                   prompt_lens=np.minimum(lens[:2], 64), mesh=colo)
    for name, kw, ref_kw in serve_ranks_arms(meshes, sp, prios):
        toks, run = serve_ranks_run(
            f"serve/ranks {name}", lambda: serve.generate(
                cfg, params, prompts, **gen_kw, **kw), dev)
        run["tokens"] = toks
        rows = sp["slots"] if "slots" in kw else sp["batch"]
        run["stored"] = stored_bytes(cfg, kw, rows, total)
        if "workers" in kw:
            run["stats"] = dict(serve._generate_fanin.last_stats)
        elif kw.get("stream") == "slots":
            run["stats"] = dict(serve._generate_slots.last_stats)
        out["arms"][name] = run
        if rank == 0:
            print(f"serve/ranks rank 0: {name} done in {run['wall_s']} s",
                  flush=True)
    if rank == 0:          # the one-process references, on this device
        for name, kw in (("batch bf16", {}), ("batch int8", dict(
                act_transport="int8")), ("slots bf16", dict(
                    stream="slots", slots=sp["slots"])),
                ("fanin", dict(workers=sp["workers"], slots=sp["slots"],
                               evict="priority", priorities=prios))):
            toks, run = serve_ranks_run(
                f"serve/one-process {name}", lambda: serve.generate(
                    cfg, params, prompts, **gen_kw, **kw), dev)
            run["tokens"] = toks
            if "workers" in kw:
                run["stats"] = dict(serve._generate_fanin.last_stats)
            out["ref"][name] = run
    t0 = time.perf_counter()
    rep = serve.disagg_decode_report(
        cfg, sp["batch"], sp["buffer"], colo, ici_bw=sp["ici_bw"],
        hbm_bw=sp["hbm_bw"], params=params, seed=seed)
    out["report"] = json.loads(json.dumps(rep, default=str))
    out["report_s"] = time.perf_counter() - t0
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # (d) expert-parallel MoE decode under the int8 transport
    mcfg = ranks_config(plan, sp["moe_arch"], sp["moe_layers"])
    mparams = model_tf.init_params(mcfg, seed=seed, device=dev,
                                   draw_on_device=dev.type == "cuda")
    mprompts = np.random.default_rng(seed + 1).integers(
        0, mcfg.vocab, (sp["moe_batch"], sp["moe_len"]), dtype=np.int32)
    a2a_ops.reset_calls()
    toks, run = serve_ranks_run("serve/ranks moe ep int8", lambda: (
        serve.generate(mcfg, mparams, mprompts, max_new=sp["moe_new"],
                       mesh=colo, rules=shd.PRESETS["ep"],
                       act_transport="int8")), dev)
    run.update(tokens=toks, a2a_calls=a2a_ops.calls(),
               stored=stored_bytes(mcfg, {"mesh": colo}, sp["moe_batch"],
                                   sp["moe_len"] + sp["moe_new"]))
    out["arms"]["moe ep int8"] = run
    if rank == 0:
        toks, run = serve_ranks_run("serve/one-process moe int8", lambda: (
            serve.generate(mcfg, mparams, mprompts, max_new=sp["moe_new"],
                           act_transport="int8")), dev)
        out["ref"]["moe int8"] = dict(run, tokens=toks)
    del mparams
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # (e) the smoke families in f32 on the (2, 2) mesh
    out["families"] = {}
    allow = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for arch in sp["families"]:
            fcfg = smoke_config(arch)
            fp = on(tree_map(lambda t: t.float(), model_tf.init_params(
                fcfg, seed=seed, device="cpu")), dev)
            fprompts = np.random.default_rng(seed + 1).integers(
                0, fcfg.vocab, (sp["family_batch"], sp["family_len"]),
                dtype=np.int32)
            t0 = time.perf_counter()
            ftoks = serve.generate(fcfg, fp, fprompts,
                                   max_new=sp["family_new"], mesh=colo)
            out["families"][arch] = {"tokens": ftoks,
                                     "wall_s": time.perf_counter() - t0}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = allow
    out["launches"] = {**dict(kern.LAUNCHES), **sweep_launches()}
    return out


def serve_ranks_family_refs(sp: dict, seed: int) -> dict:
    """Each smoke family's one-process tokens on the CPU, with every
    step's logits for the first difference's margin."""
    refs = {}
    cpu = torch.device("cpu")
    for arch in sp["families"]:
        fcfg = smoke_config(arch)
        fp = tree_map(lambda t: t.float(), model_tf.init_params(
            fcfg, seed=seed, device=cpu))
        fprompts = np.random.default_rng(seed + 1).integers(
            0, fcfg.vocab, (sp["family_batch"], sp["family_len"]),
            dtype=np.int32)
        with ServeProbe(arch, keep_all=True) as probe:
            toks = serve.generate(fcfg, fp, fprompts,
                                  max_new=sp["family_new"])
        refs[arch] = (toks, probe.prefill_logits, probe.decode_logits)
    return refs


def per_rank_runs(res: list, arm: str) -> list:
    return [r["serve"]["arms"][arm] for r in res]


def per_rank(res: list, arm: str, key: str) -> list:
    return [r[key] for r in per_rank_runs(res, arm)]


def report_serve_ranks(res: list, plan: dict, args, smi: str) -> int:
    """Phase 13's lines and gates from the ranks' results; returns the
    kernel launches on the ``serve@4`` path (summed over the ranks)."""
    t_phase = time.perf_counter()
    sp = plan["serve"]
    s0 = res[0]["serve"]
    bar = ROW_REL_BAR[torch.bfloat16]
    print(f"serve/ranks ({smi}): {RANKS_W} ranks of phase 12's group, "
          f"meshes {json.dumps(s0['meshes'])}; reduced: " + json.dumps({
              f"{sp['arch']} depth (40)": sp["layers"],
              f"{sp['arch']} new tokens (phase 11: {SERVE_NEW})": sp["new"],
              f"{sp['moe_arch']} depth (48)": sp["moe_layers"],
              f"{sp['moe_arch']} requests": [sp["moe_batch"],
                                             sp["moe_len"]]}))
    ref = s0["ref"]
    for name, run0 in s0["arms"].items():
        runs = per_rank_runs(res, name)
        print(f"serve/ranks {name}: end to end s per rank "
              f"{[r['wall_s'] for r in runs]}; time to the first token s "
              f"per rank {[r['ttft_s'] for r in runs]}; decode steps "
              f"{[r['n_decode'] for r in runs]}, median ms per rank "
              f"{[r['decode_ms'] for r in runs]}; prefill median ms per "
              f"rank {[r['prefill_ms'] for r in runs]}; peak GiB per rank "
              f"{[r['peak_gib'] for r in runs]}; cache bytes per rank as "
              f"stored {[r['stored'] for r in runs]}; wire bytes by kind "
              f"per rank {json.dumps([r['wire'] for r in runs])}"
              + (f"; stats {json.dumps(run0['stats'])}"
                 if "stats" in run0 else ""))
        vocab = ranks_config(plan, sp["moe_arch"] if name.startswith("moe")
                             else sp["arch"]).vocab
        assert all(r["finite"] for r in runs), name
        assert all(np.array_equal(r["tokens"], run0["tokens"])
                   for r in runs), name
        assert ((run0["tokens"] >= 0) & (run0["tokens"] < vocab)).all()
    # the first prefill's and the first decode step's logits against one
    # process on the same weights. A decode row is held where both runs
    # fed it the same token: at full width the random weights' logits
    # are nearly flat, so a prefill rounded in another order may pick
    # another first token (near-tie), and that row's next logits then
    # answer another input; such a row is held by the one-process
    # prefill's top-2 margin instead, under the bar
    arms = s0["arms"]

    def first(name, key):
        return next(r["serve"]["arms"][name][key] for r in res
                    if r["serve"]["arms"][name][key] is not None)

    # (one-process reference, decode bar, prefill bar): under the int8
    # transport a last-bit difference in a gathered activation can cross
    # an int8 rounding boundary (one step is 1/127 of its block's largest
    # value), so a prefill that runs that gather in every layer is held
    # to the reference's int8 bar (an NVIDIA H100 80GB HBM3 at 700 W read
    # 0.0205 colocated)
    i8 = STORAGE_BARS["int8"]
    gates = {
        "colocated bf16": ("batch bf16", bar, bar),
        "colocated int8": ("batch int8", bar, i8),
        "disagg bf16xbf16": ("batch bf16", bar, bar),
        "disagg int8xbf16": ("batch bf16", bar, bar),
        "disagg int8xint8": ("batch bf16", i8, bar),
        "disagg bf16xf8": ("batch bf16", STORAGE_BARS["f8"], bar),
        "slots bf16": ("slots bf16", bar, bar),
        "fanin": ("fanin", bar, bar),
        "moe ep int8": ("moe int8", bar, i8),
    }
    errs = {}
    for name, (rname, b, pre_bar) in gates.items():
        want = ref[rname]
        pre_err = serve_logits_err(torch.from_numpy(first(name,
                                                          "first_prefill")),
                                   torch.from_numpy(want["first_prefill"]))
        same = (first(name, "first_decode_tokens")
                == want["first_decode_tokens"]).all(axis=-1)
        got_d = torch.from_numpy(first(name, "first_decode"))
        want_d = torch.from_numpy(want["first_decode"])
        dec_err = serve_logits_err(got_d[same], want_d[same]) \
            if same.any() else float("nan")
        margins = []
        if not same.all() and name.split()[0] in ("colocated", "disagg",
                                                  "moe"):
            pl = torch.from_numpy(want["first_prefill"])
            scale = max(1.0, float(pl.abs().max()))
            margins = [top2_margin(pl[r]) / scale
                       for r in np.nonzero(~same)[0]]
        errs[name] = {"prefill": pre_err, "decode": dec_err,
                      "rows held": int(same.sum()), "rows": int(same.size),
                      "tie margins": margins}
        assert pre_err <= pre_bar, (name, pre_err)
        assert same.any() and dec_err <= b, (name, errs[name], b)
        assert all(m <= bar for m in margins), (name, margins)
        assert same.all() or margins or \
            name.split()[0] in ("slots", "fanin"), (name, errs[name])
    print(f"serve/ranks first prefill's and first decode step's logits "
          f"against one process on the same weights, max |diff| over the "
          f"scale (bars: {bar}, prefill under the int8 transport "
          f"{STORAGE_BARS['int8']}; decode under int8 storage "
          f"{STORAGE_BARS['int8']}, f8 {STORAGE_BARS['f8']}, against one "
          f"process's bf16 storage; a decode row held where both fed it the "
          f"same token, else the one-process prefill's top-2 margin over "
          f"the scale under {bar}): {json.dumps(errs)}; one-process runs: "
          + json.dumps({
              k: {"wall_s": v["wall_s"], "ttft_s": v["ttft_s"],
                  "decode_ms": v["decode_ms"], "peak_gib": v["peak_gib"]}
              for k, v in ref.items()}))
    agree = {n: float((a["tokens"] == ref["batch bf16"]["tokens"]).all(
        axis=1).mean()) for n, a in arms.items() if not n.startswith("moe")}
    print(f"serve/ranks rows whose tokens equal one process's batch bf16 "
          f"(printed): {json.dumps(agree)}")
    # the wire: int8 below bf16 over 1.5
    for r in res:
        a = r["serve"]["arms"]
        b16 = a["colocated bf16"]["wire"].get("act_gather_bf16", 0)
        i8 = a["colocated int8"]["wire"].get("act_gather_int8", 0)
        assert 0 < i8 <= b16 / 1.5, (b16, i8)
    pre = s0["meshes"]["pre"]
    mv = {k: sum(res[p]["serve"]["arms"][f"disagg {k}xbf16"]["wire"].get(
        f"cache_move_{k}", 0) for p in pre) for k in ("bf16", "int8")}
    gb16 = sum(r["serve"]["arms"]["colocated bf16"]["wire"].get(
        "act_gather_bf16", 0) for r in res)
    gi8 = sum(r["serve"]["arms"]["colocated int8"]["wire"].get(
        "act_gather_int8", 0) for r in res)
    print(f"serve/ranks wire: colocated act_gather bf16 {gb16} bytes, int8 "
          f"{gi8} ({gb16 / gi8}x); disaggregated handoff cache_move bf16 "
          f"{mv['bf16']} bytes, int8 {mv['int8']} ({mv['bf16'] / mv['int8']}"
          f"x); bar 1.5x each")
    assert 0 < mv["int8"] <= mv["bf16"] / 1.5, mv
    # (c) the fan-in's counts against one process
    keys = ("admissions", "evictions", "requeues", "decode_steps")
    got = {k: arms["fanin"]["stats"][k] for k in keys}
    want = {k: ref["fanin"]["stats"][k] for k in keys}
    print(f"serve/ranks fanin counts across the fan-in meshes {got} "
          f"against one process {want}; tokens equal one process's "
          f"{bool(np.array_equal(arms['fanin']['tokens'], ref['fanin']['tokens']))}")
    assert got == want, (got, want)
    # (d)
    moe = arms["moe ep int8"]
    n_layers = ranks_config(plan, sp["moe_arch"], sp["moe_layers"]).n_layers
    print(f"serve/ranks moe ep int8: expert_a2a calls per rank "
          f"{per_rank(res, 'moe ep int8', 'a2a_calls')} ({n_layers} layers x "
          f"{sp['moe_new']} decode steps), its wire "
          f"{[r['serve']['arms']['moe ep int8']['wire'].get('expert_a2a_int8', 0) for r in res]}"
          f" bytes per rank; tokens equal one process's "
          f"{bool(np.array_equal(moe['tokens'], ref['moe int8']['tokens']))}")
    assert all(n == n_layers * sp["moe_new"]
               for n in per_rank(res, "moe ep int8", "a2a_calls"))
    # (e)
    refs = serve_ranks_family_refs(sp, args.seed)
    for arch, (want_t, pre_l, dec_l) in refs.items():
        fam = s0["families"][arch]
        assert all(np.array_equal(r["serve"]["families"][arch]["tokens"],
                                  fam["tokens"]) for r in res), arch
        diff = first_difference(fam["tokens"], want_t)
        if diff is None:
            print(f"serve/ranks {arch} smoke f32 on the (2, 2) mesh, card "
                  f"against one CPU process: greedy tokens equal "
                  f"({fam['tokens'].size} tokens, {fam['wall_s']} s)")
            continue
        r, t = diff
        lg = pre_l[0] if t == 0 else dec_l[t - 1]
        margin = top2_margin(lg[r]) / max(1.0, float(lg.abs().max()))
        print(f"serve/ranks {arch} smoke f32 on the (2, 2) mesh: tokens "
              f"differ first at row {r} step {t}; the CPU's top-2 margin "
              f"there {margin} of scale (bar {SERVE_F32_TOL})")
        assert margin <= SERVE_F32_TOL, (arch, margin)
    # the reports
    rep = s0["report"]
    print(f"serve/ranks disagg_decode_report {sp['arch']} batch "
          f"{sp['batch']} x {sp['buffer']} on the colocated "
          f"(2, 2) mesh ({s0['report_s']} s, priced at ici_bw "
          f"{sp['ici_bw']}, hbm_bw {sp['hbm_bw']}): {json.dumps(rep)}")
    assert set(rep["cells"]) == {f"{t}x{s}" for t in ("bf16", "int8")
                                 for s in ("bf16", "int8", "f8")}
    fcfg = ranks_config(plan, sp["arch"], sp["layers"])
    fan = serve.fanin_report(
        fcfg, sp["batch"], sp["buffer"], workers=sp["workers"],
        slots=sp["slots"], classes=sp["classes"], evict="priority",
        max_new=sp["new"],
        decode_step_s=statistics.median(
            [r["decode_ms"] for r in per_rank_runs(res, "fanin")
             if r["n_decode"]]) / 1e3,
        transfer_s=statistics.median(
            [r["prefill_ms"] for r in per_rank_runs(res, "fanin")
             if not math.isnan(r["prefill_ms"])]) / 1e3)
    print(f"serve/ranks fanin_report for the same workload (decode step and "
          f"prefill priced at the fanin arm's medians): {json.dumps(fan)}")
    launches = {}
    for r in res:
        for k, n in r["serve"]["launches"].items():
            launches[k] = launches.get(k, 0) + n
    print(f"serve/ranks: launches summed over the ranks "
          f"{json.dumps(launches)} (no kernel on the path); report wall "
          f"{time.perf_counter() - t_phase} s")
    assert not any(launches.values()), launches
    return sum(launches.values())


# phase 14's cells: (CLI arguments, the record tags they write)
DRYRUN_CELLS = (
    (["--arch", "paper-lm-100m", "--shape", "train_4k",
      "--grad-transport", "both"],
     ["paper-lm-100m__train_4k__16x16",
      "paper-lm-100m__train_4k__16x16__int8_ef"]),
    (["--arch", "granite-3-8b", "--shape", "decode_32k", "--preset",
      "serve_sp", "--act-transport", "both"],
     ["granite-3-8b__decode_32k__16x16__serve_sp",
      "granite-3-8b__decode_32k__16x16__serve_sp-act_int8"]),
    (["--arch", "qwen3-moe-30b-a3b,hubert-xlarge", "--shape", "decode_32k",
      "--preset", "ep"],
     ["qwen3-moe-30b-a3b__decode_32k__16x16__ep",
      "hubert-xlarge__decode_32k__16x16__ep"]),
)
DRYRUN_TIMEOUT_S = 300


def phase_dryrun(smi: str) -> dict:
    """Phase 14: ``python -m repro_torch.launch.dryrun`` on the card's
    fake (16, 16) world, one subprocess per row of ``DRYRUN_CELLS``; the
    records are read back and gated. Returns them by tag."""
    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    recs = {}
    try:
        for argv, tags in DRYRUN_CELLS:
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--mesh", "pod", "--out", out, "--force"] + argv,
                capture_output=True, text=True, env=env, cwd=ROOT,
                timeout=DRYRUN_TIMEOUT_S)
            wall = time.time() - t0
            for line in proc.stdout.splitlines():
                print(f"dryrun/log {line}")
            if proc.returncode != 0:
                print(proc.stderr[-3000:], file=sys.stderr)
                raise RuntimeError(f"dryrun: {' '.join(argv)} exited "
                                   f"{proc.returncode}")
            print(f"dryrun/run {' '.join(argv)}: {wall:.1f} s with the "
                  f"subprocess's imports ({smi})")
            for tag in tags:
                with open(os.path.join(out, tag + ".json")) as f:
                    recs[tag] = json.load(f)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for tag, rec in recs.items():
        if tag.startswith("hubert-xlarge"):
            assert rec["status"] == "skip", rec
            assert rec["skip_reason"] == \
                "encoder-only arch: no decode step", rec
            print(f"dryrun/{tag}: skip ({rec['skip_reason']})")
            continue
        assert rec["status"] == "ok", (tag, rec.get("error"),
                                       rec.get("traceback"))
        r = rec["roofline"]
        jc = rec["jaxpr_cost"]
        print(f"dryrun/{tag}: wall {rec['wall_s']} s (cost walk "
              f"{rec['jaxpr_cost_s']} s, mesh trace {rec['collectives_s']} "
              f"s) on the host ({smi}); dot_flops {jc['dot_flops']:.6g} "
              f"hbm_bytes {jc['hbm_bytes']:.6g}; compute_s "
              f"{r['compute_s']:.6g} memory_s {r['memory_s']:.6g} "
              f"collective_s {r['collective_s']:.6g} (bf16 "
              f"{r['collective_s_bf16']:.6g}, int8 "
              f"{r['collective_s_int8']:.6g}) dominant {r['dominant']} "
              f"roofline_fraction {r['roofline_fraction']:.6g}")
        print(f"dryrun/{tag} collectives: " + json.dumps(
            {op: [rec["collectives"][op]["count"],
                  rec["collectives"][op]["wire_bytes_bf16eq"]]
             for op in ("all-reduce", "all-gather", "reduce-scatter",
                        "all-to-all", "collective-permute")}))
        print(f"dryrun/{tag} by kind: " + json.dumps(
            {k: v["wire_bytes_bf16eq"]
             for k, v in rec["collectives_by_kind"].items()}))
        if "disagg" in rec:
            d = rec["disagg"]
            print(f"dryrun/{tag} disagg: " + json.dumps(
                {n: [c["transfer_wire_bytes_bf16eq"],
                     c["decode_wire_bytes_bf16eq"],
                     c["cache_resident_bytes_per_device"]]
                 for n, c in d["cells"].items()}) + f" trace {d['trace_s']} s")
            print(f"dryrun/{tag} fanin: admission wait "
                  f"{rec['fanin']['fanin_admission_wait_s']:.6g} s, "
                  f"evictions {rec['fanin']['fanin_evictions']}")
    train = recs["paper-lm-100m__train_4k__16x16__int8_ef"]
    assert "int8_ef_gather" not in train["collectives_by_kind"] or \
        train["collectives_by_kind"]["int8_ef_gather"]["wire_bytes_bf16eq"] \
        < train["collectives"]["total_wire_bytes_bf16eq"] / 10, \
        train["collectives_by_kind"]
    granite = recs["granite-3-8b__decode_32k__16x16__serve_sp"]
    act = granite["act_gather_wire_bytes_bf16eq"]
    print(f"dryrun/act_gather wire bf16eq: bf16 {act['bf16']} int8 "
          f"{act['int8']} ({act['bf16'] / max(act['int8'], 1):.3f}x)")
    assert 0 < act["int8"] < act["bf16"] / 1.5, act
    moe = recs["qwen3-moe-30b-a3b__decode_32k__16x16__ep"]
    a2a = moe["other_transport"]["collectives_by_kind"].get(
        "expert_a2a_int8", {"count": 0, "wire_bytes_bf16eq": 0})
    print(f"dryrun/expert_a2a under ep, int8 program: {a2a['count']} "
          f"collectives, {a2a['wire_bytes_bf16eq']} bf16eq wire bytes")
    return recs


def main() -> int:
    args = parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card",
              file=sys.stderr)
        return 1
    reduced = {k: getattr(args, k) for k in DEFAULTS
               if getattr(args, k) != DEFAULTS[k]}
    reduced["fleet/corpus shards per write x"] = FLEET_FACTOR
    reduced["model/train micro-batch (train_4k: 32)"] = args.model_batch
    reduced["train/step_4k micro-batch (train_4k: 32)"] = args.model_batch
    reduced["serve/granite-3-8b batch (decode_32k: 128)"] = SERVE_BATCH
    reduced["serve/granite-3-8b horizon (decode_32k: 32768)"] = \
        f"<= {SERVE_BUFFER + SERVE_NEW}"
    reduced["train/ranks granite-3-8b depth (40)"] = \
        RANKS_PLAN["spmd_layers"]
    reduced["train/ranks launcher (60 steps, cycle/25, ckpt/20)"] = \
        RANKS_PLAN["launch_argv"] + [
            f"ckpt every {RANKS_PLAN['launch_ckpt_every']}"]
    reduced["serve/ranks granite-3-8b depth (40)"] = \
        SERVE_RANKS_PLAN["layers"]
    reduced["serve/ranks granite-3-8b new tokens (phase 11: 64)"] = \
        SERVE_RANKS_PLAN["new"]
    reduced["serve/ranks qwen3-moe-30b-a3b depth (48)"] = \
        SERVE_RANKS_PLAN["moe_layers"]
    print(f"reduced: {json.dumps(reduced)}")
    tuned_dir = tempfile.mkdtemp(prefix="chip_smoke_tuned_")
    os.environ["REPRO_TORCH_TUNED_DIR"] = tuned_dir
    tuned.invalidate_memo()
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        smi, name = phase_device()
        phase_build()
        phase_parity(dev)
        phase_parity_full_bin(dev, bin_chunks(args), args.selectivity)
        phase_parity_sweep_ops(dev)
        launches, largest = phase_main_path(args, dev)
        kernels = phase_times(args, dev, launches, largest)
        del largest
        cells = full_width_cells(args.seed, dev)
        phase_full_width_parity(cells, "default")
        phase_full_width_faults(cells)
        sweep_counts, _ = phase_sweep_path(cells)
        errs = phase_full_width_parity(cells, "tuned")
        phase_example_parity()
        kernels += phase_full_width_times(cells, sweep_counts, errs,
                                          args.reps)
        del cells
        fleet_counts = phase_corpus_fleet(args, dev)
        assert all(n > 0 for n in fleet_counts.values()), fleet_counts
        for k in kernels:
            if k["name"] in fleet_counts:
                k["launches_by_path"] = {"compaction": k["launches"],
                                         "fleet": fleet_counts[k["name"]]}
                k["launches"] += fleet_counts[k["name"]]
        phase_storm_fleet(args)
        fwd_bwd_ms = phase_model(args, dev, smi)
        train_chunks = phase_train(args, dev, smi, fwd_bwd_ms)
        for k in kernels:
            if k["name"] == "compact_chunks":
                k["launches_by_path"]["train"] = train_chunks
                k["launches"] += train_chunks
        phase_serve(args, dev, smi)
        for k in kernels:
            k.setdefault("launches_by_path", {})["serve"] = 0
        ranks_chunks, serve4 = phase_ranks(
            args, dev, smi, dict(RANKS_PLAN, serve=SERVE_RANKS_PLAN))
        for k in kernels:
            if k["name"] == "compact_chunks":
                k["launches_by_path"]["train@4"] = ranks_chunks
                k["launches"] += ranks_chunks
            k["launches_by_path"]["serve@4"] = 0
        assert serve4 == 0, serve4
        phase_dryrun(smi)
    finally:
        shutil.rmtree(tuned_dir, ignore_errors=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
