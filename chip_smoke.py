#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--shards 1024] [--tokens-per-shard 262000]
                          [--target-mib 512] [--selectivity 0.05] [--seed 0]

Needs one CUDA card and ``nvcc``. Phases, each reported on its own lines:

1. the card: ``nvidia-smi`` name and power limit, and torch's device name;
2. build: every kernel under ``src/repro_torch/kernels/csrc`` (setup time);
3. each kernel against its plain PyTorch version on the card, bit for bit
   (``torch.equal`` on the bits), over the plan x ``block_chunks`` grid, the
   keep fractions of the fused filter, three dtypes and one full-size bin;
4. the main path: one training-corpus table fed by CDC trickle ingest, one
   AutoComp cycle compacting it to Iceberg's default 512 MiB target file
   size, and one GDPR-style rewrite-delete through the retention queue --
   checked against numpy at full size, with the kernels' launch counts;
5. each kernel timed at the main path's own inputs with CUDA events, beside
   its bandwidth bound, its plain version and one PyTorch library call.

It exits non-zero when a phase fails, and prints as its last line
``{"ok": true, "device": {...}}`` only when every phase passed.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (AutoCompPipeline, ComputeCostTrait,  # noqa: E402
                              FileCountReductionTrait, FileEntropyTrait,
                              MoopRanker, RetentionQueue, Scope,
                              StatsCollector, TraitContext)
from repro_torch.core.act import Scheduler  # noqa: E402
from repro_torch.data import packing  # noqa: E402
from repro_torch.data.shards import (TokenShardWriter, decode_shard,  # noqa: E402
                                     decode_shard_padded)
from repro_torch.kernels import api, build  # noqa: E402
from repro_torch.kernels.compact_pack import compact_pack as kern  # noqa: E402
from repro_torch.kernels.compact_pack import ops, ref  # noqa: E402
from repro_torch.lst import (Catalog, InMemoryStore,  # noqa: E402
                             PredicateDelete, plan_rewrite_delete)
from repro_torch.lst.compaction import plan_table  # noqa: E402
from repro_torch.lst.workload import SimClock  # noqa: E402

MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA's data sheet
CHUNK_ROWS, CHUNK_COLS = kern.CHUNK_ROWS, kern.CHUNK_COLS
CHUNK_TOKENS = kern.CHUNK_TOKENS
SOURCE = "src/repro_torch/kernels/csrc/compact_pack.cu"
REPLACES = {
    "compact_chunks": "src/repro/kernels/compact_pack/compact_pack.py:58",
    "compact_filter": "src/repro/kernels/compact_pack/compact_pack.py:128",
}
DEFAULTS = {"shards": 1024, "commits": 8, "tokens_per_shard": 262_000,
            "target_mib": 512, "selectivity": 0.05, "seed": 0}


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


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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


def phase_build():
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")


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
        payloads = [decode_shard_padded(before[f.path]) for f in task.inputs]
        rows = np.concatenate(payloads).reshape(-1, CHUNK_COLS)
        valid = np.zeros(rows.shape[0], bool)
        row0 = 0
        for f, p in zip(task.inputs, payloads):
            valid[row0: row0 + -(-f.num_rows // CHUNK_COLS)] = True
            row0 += p.shape[0] // CHUNK_COLS
        drop = drop_rows(rows)
        got = decode_shard(store.get(output_for(table, task.task_id).path))
        assert np.array_equal(got, rows[valid & ~drop].reshape(-1)), \
            task.task_id
        want_dropped += int((valid & drop).sum())
        valid_rows += int(valid.sum())
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
    results.append(dict(
        name="compact_chunks", route="cuda", source=SOURCE,
        replaces=REPLACES["compact_chunks"],
        launches=launches["compact_chunks"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=1e3 * n_bytes / HBM_BYTES_PER_S,
        bound_by="bytes", library_ms=lib_ms))
    print(f"compact_chunks: {cm.shape[0]} chunks, block_chunks {g}, "
          f"{n_bytes} bytes moved; kernel {ms} ms "
          f"({n_bytes / ms / 1e6} GB/s), plain {plain_ms} ms, "
          f"index_select {lib_ms} ms, bound {results[-1]['bound_ms']} ms")
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
    # the identity plan: kept rows of the packed stream are rows of src
    assert np.array_equal(cm, np.arange(cm.shape[0]))
    lib_ms = time_ms(lambda: torch.index_select(rows, 0, kept_rows), reps)
    results.append(dict(
        name="compact_filter", route="cuda", source=SOURCE,
        replaces=REPLACES["compact_filter"],
        launches=launches["compact_filter"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=1e3 * n_bytes / HBM_BYTES_PER_S,
        bound_by="bytes", library_ms=lib_ms))
    print(f"compact_filter: {cm.shape[0]} chunks, {n_kept} of "
          f"{keep.size} rows kept, {n_out} output chunks, {n_bytes} bytes "
          f"moved; kernel {ms} ms ({n_bytes / ms / 1e6} GB/s), plain "
          f"{plain_ms} ms, index_select of kept rows {lib_ms} ms, bound "
          f"{results[-1]['bound_ms']} ms")
    return results


def main() -> int:
    args = parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card",
              file=sys.stderr)
        return 1
    reduced = {k: getattr(args, k) for k in DEFAULTS
               if getattr(args, k) != DEFAULTS[k]}
    print(f"reduced: {json.dumps(reduced)}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi, name = phase_device()
    phase_build()
    phase_parity(dev)
    phase_parity_full_bin(dev, bin_chunks(args), args.selectivity)
    launches, largest = phase_main_path(args, dev)
    kernels = phase_times(args, dev, launches, largest)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
