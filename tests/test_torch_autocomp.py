"""The slice as a whole: one AutoComp cycle and one rewrite-delete, run by
the JAX package and by the port on the same token-shard table, on the CPU.

The table is the one of tests/test_retention.py::TestFleetRewriteBitMatch
(vocab 997, seed 3, 3 trickle commits of 6 shards x 3000 tokens), written
by each package's own writer. The cycle is wired as
``launch/train.py::build_autocomp`` wires it, with a 64 KiB target so the
18 shards fall into four bins. The delete is a one-shot ``PredicateDelete``
through ``RetentionQueue.propose`` -> ``Scheduler.execute`` ->
``RetentionQueue.note_executed``, with the fused filter on and off. The
two packages must leave identical store objects (every data and metadata
blob, byte for byte) and report identical ``files_removed``, ``gbhr`` and
``rows_dropped``; tolerance 0 throughout.
"""

import dataclasses
import functools

import numpy as np
import pytest

import repro.core as jcore
import repro.core.act as jact
import repro.core.retention as jret
import repro.data as jdata
import repro.lst as jlst
import repro.lst.workload as jwl
import repro_torch.core as tcore
import repro_torch.core.act as tact
import repro_torch.core.retention as tret
import repro_torch.data as tdata
import repro_torch.lst as tlst
import repro_torch.lst.workload as twl

TARGET = 64 << 10


@dataclasses.dataclass(frozen=True)
class Pkg:
    name: str
    core: object
    act: object
    ret: object
    data: object
    lst: object
    wl: object
    merge_fn: object


JAX = Pkg("jax", jcore, jact, jret, jdata, jlst, jwl,
          jdata.merge_shards_fn)
TORCH = Pkg("torch", tcore, tact, tret, tdata, tlst, twl,
            functools.partial(tdata.merge_shards_fn, device="cpu"))


def drop_even(rows, task):
    return rows[:, 0] % 2 == 0          # DROP even-leading rows


def write_table(pkg):
    clock = pkg.wl.SimClock()
    store = pkg.lst.InMemoryStore()
    cat = pkg.lst.Catalog(store, now_fn=clock.now)
    t = cat.create_table("train", "corpus",
                         properties={"conflict_granularity": "table"})
    t.now_fn = clock.now
    w = pkg.data.TokenShardWriter(t, vocab=997, seed=3)
    for _ in range(3):
        w.trickle_append(n_files=6, tokens_per_file=3000)
    return clock, cat, t, store


def build_autocomp(pkg, target_bytes=TARGET, top_k=4):
    c = pkg.core
    return c.AutoCompPipeline(
        stats=c.StatsCollector(target_bytes),
        traits=(c.FileCountReductionTrait(), c.FileEntropyTrait(),
                c.ComputeCostTrait()),
        trait_ctx=c.TraitContext(target_file_bytes=target_bytes),
        ranker=c.MoopRanker({"file_count_reduction": 0.7,
                             "compute_cost": 0.3}),
        scheduler=pkg.act.Scheduler(target_bytes, merge_fn=pkg.merge_fn),
        scope=c.Scope.TABLE, top_k=top_k)


def rewrite_delete(pkg, t, fused):
    queue = pkg.ret.RetentionQueue(target_file_bytes=TARGET)
    queue.submit(pkg.lst.PredicateDelete(
        "purge", row_predicate=drop_even, est_selectivity=0.5,
        tables=(t.table_id,)))
    cands = queue.propose([t])
    act = pkg.act.Scheduler(TARGET, merge_fn=pkg.merge_fn,
                            fused_filter=fused).execute(cands)
    for c in cands:
        queue.note_executed(c)
    assert not queue.has_pending()
    return act


def objects(store):
    return {p: store.get(p) for p in store.list("")}


@functools.lru_cache(maxsize=None)
def run(pkg_name, fused):
    pkg = JAX if pkg_name == "jax" else TORCH
    clock, cat, t, store = write_table(pkg)
    cycle = build_autocomp(pkg).run_cycle(cat)
    after_cycle = objects(store)
    clock.advance(1.0)
    act = rewrite_delete(pkg, t, fused)
    return dict(cycle=(cycle.files_removed, cycle.gbhr),
                after_cycle=after_cycle,
                delete=(act.files_removed, act.gbhr, act.rows_dropped),
                after_delete=objects(store),
                metrics=store.metrics.snapshot())


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two-pass"])
def test_cycle_and_delete_leave_identical_stores(fused):
    j, p = run("jax", fused), run("torch", fused)
    assert p["cycle"] == j["cycle"]
    assert p["cycle"][0] == 18            # every shard went into a bin
    assert p["after_cycle"] == j["after_cycle"]
    assert p["delete"] == j["delete"]
    assert p["delete"][2] > 0
    assert p["after_delete"] == j["after_delete"]
    assert p["metrics"] == j["metrics"]


def test_fused_and_two_pass_commit_identical_tables():
    a, b = run("torch", True), run("torch", False)
    assert a["after_delete"] == b["after_delete"]
    assert a["delete"] == b["delete"]


def test_delete_held_and_tokens_survive():
    """Every surviving 128-token row leads odd, and the cycle kept every
    token of the 18 shards, in order."""
    _, _, t, store = write_table(JAX)
    want = np.concatenate([jdata.decode_shard(store.get(f.path))
                           for f in t.current_files()])
    p = run("torch", True)
    shards = {k: tdata.decode_shard(v) for k, v in p["after_cycle"].items()
              if k.endswith(".toks")}
    got = np.concatenate([shards[k] for k in sorted(shards)])
    assert np.array_equal(np.sort(got), np.sort(want))
    for k, v in p["after_delete"].items():
        if k.endswith(".toks"):
            arr = tdata.decode_shard(v)
            assert (arr.reshape(-1, 128)[:, 0] % 2 == 1).all()


def test_jax_written_table_compacts_identically_in_the_port():
    """Move the table the JAX package wrote into the port with
    ``lst/interop.py::load_table``, then compact and rewrite-delete it in
    both. The port's table has one commit where the JAX one has three, so
    metadata and output names differ; the data files' bytes must not."""
    j = run("jax", True)
    _, _, jt, jstore = write_table(JAX)
    files = [dataclasses.asdict(f) for f in jt.current_files()]
    objs = {f["path"]: jstore.get(f["path"]) for f in files}

    clock = twl.SimClock()
    cat = tlst.Catalog(tlst.InMemoryStore(), now_fn=clock.now)
    t = tlst.load_table(cat, "train", "corpus", files, objs,
                        properties={"conflict_granularity": "table"})
    t.now_fn = clock.now
    assert [dataclasses.asdict(f) for f in t.current_files()] == files
    cycle = build_autocomp(TORCH).run_cycle(cat)
    assert (cycle.files_removed, cycle.gbhr) == j["cycle"]
    clock.advance(1.0)
    act = rewrite_delete(TORCH, t, fused=True)
    assert (act.files_removed, act.gbhr, act.rows_dropped) == j["delete"]
    got = sorted(t.store.get(f.path) for f in t.current_files())
    want = sorted(v for k, v in j["after_delete"].items()
                  if k.endswith(".toks"))
    assert len(got) == len(want) > 1 and got == want
