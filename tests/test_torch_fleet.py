"""The fleet scheduler, the service and its triggers of the port against the
JAX package's, on the CPU, tolerance 0.

Each scenario of ``tests/test_fleet.py``, ``tests/test_system.py``'s
service and trigger tests and ``tests/test_retention.py``'s fleet
rewrite-delete runs once in each package on the same inputs; the
``FleetCycleReport`` / ``CycleReport`` fields (``wall_s``, a host clock,
excepted), ``totals()`` and store objects must be equal. The README's
fleet run (48 tables, 3 cycles, budget 6, retention) runs through
``chip_smoke.py``'s reproduction of the bench in both packages, and that
reproduction is held to ``benchmarks/bench_fleet.py`` itself. A
2000-table ``FleetSpec()`` fleet built by the JAX generator is carried
into the port with ``lst/interop.py::load_catalog``, so both schedulers
start one cycle from the same fleet. ``chip_smoke.py``'s ``fleet/corpus``
harness runs at 6 tables of small shards in both packages.
"""

import dataclasses
import functools
import itertools
import pathlib
import sys

import numpy as np
import pytest

import repro.core as jcore
import repro.core.act as jact
import repro.core.fleet as jfleet
import repro.core.model as jmodel
import repro.core.observe as jobserve
import repro.core.service as jservice
import repro.core.triggers as jtriggers
import repro.data as jdata
import repro.lst as jlst
import repro.lst.workload as jwl
import repro_torch.core as tcore
import repro_torch.core.act as tact
import repro_torch.core.fleet as tfleet
import repro_torch.core.model as tmodel
import repro_torch.core.observe as tobserve
import repro_torch.core.service as tservice
import repro_torch.core.triggers as ttriggers
import repro_torch.data as tdata
import repro_torch.lst as tlst
import repro_torch.lst.workload as twl

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from benchmarks import workload_sim  # noqa: E402
from benchmarks.bench_fleet import run_fleet  # noqa: E402

MB = 1 << 20


def _lib(core, act, fleet, service, lst, wl, data, model, observe, triggers,
         merge_fn):
    lib = cs.fleet_lib(core, act, fleet, service, lst, wl, data)
    lib.model, lib.observe, lib.triggers = model, observe, triggers
    lib.merge_fn = merge_fn
    return lib


JAX = _lib(jcore, jact, jfleet, jservice, jlst, jwl, jdata, jmodel,
           jobserve, jtriggers, jdata.merge_shards_fn)
TORCH = _lib(tcore, tact, tfleet, tservice, tlst, twl, tdata, tmodel,
             tobserve, ttriggers,
             functools.partial(tdata.merge_shards_fn, device="cpu"))
LIBS = (JAX, TORCH)


def report(rep):
    """Every field of a cycle report but the host clock, with its act
    results in full."""
    out = {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)
           if f.name not in ("wall_s", "act")}
    out["files_removed"], out["gbhr"] = rep.files_removed, rep.gbhr
    if rep.act is not None:
        out["results"] = [dataclasses.asdict(r) for r in rep.act.results]
        out["deferred"] = [c.key for c in rep.act.deferred]
    return out


def objects(store):
    return {p: store.get(p) for p in store.list("")}


# ------------------------------------------------------ test_fleet's worlds
def mk_world(L):
    clock = L.wl.SimClock()
    store = L.lst.InMemoryStore()
    return clock, store, L.lst.Catalog(store, now_fn=clock.now)


def small_appender(L):
    """``append_small`` of tests/test_fleet.py with its own file ids, so
    both packages name the same files alike."""
    ids = itertools.count(1)

    def append_small(table, n, size_mb=1.0, partition=None):
        files = []
        for _ in range(n):
            path = f"{table.table_id}/data/part-{next(ids):08d}.parquet"
            table.store.put(path, b"x")
            files.append(L.lst.DataFile(path, int(size_mb * MB), 100,
                                        partition))
        table.append(files)
        return files
    return append_small


def mk_fleet_world(L, n_tables, n_files=10, budget=1.0, **fleet_kw):
    clock, store, catalog = mk_world(L)
    append_small = small_appender(L)
    catalog.create_namespace("db", total_quota=10_000_000)
    tables = []
    for i in range(n_tables):
        t = catalog.create_table("db", f"t{i:03d}", None)
        t.now_fn = clock.now
        append_small(t, n_files)
        tables.append(t)
    fleet = L.fleet.FleetScheduler(catalog, budget_gbhr=budget, **fleet_kw)
    return clock, catalog, tables, fleet, append_small


def mk_pool_candidate(L, i, benefit, cost, unpriced=False):
    _, _, catalog = mk_world(L)
    catalog.create_namespace("p", total_quota=10_000)
    t = catalog.create_table("p", f"t{i:03d}", None)
    small_appender(L)(t, 2)
    c = L.model.Candidate(t, L.model.Scope.TABLE)
    L.observe.StatsCollector(512 * MB).observe(c)
    c.traits = {"file_count_reduction": float(benefit)}
    if not unpriced:
        c.traits["compute_cost"] = float(cost)
    c.fleet_class = "steady"
    return c


def pool_fleet(L, **kw):
    return L.fleet.FleetScheduler(mk_world(L)[2], **kw)


def pool_values(case):
    rng = np.random.RandomState(case)
    n = rng.randint(1, 26)
    return ([(float(rng.uniform(0, 1e4)), float(rng.uniform(0.01, 10.0)),
              bool(rng.rand() < 0.2)) for _ in range(n)],
            float(rng.uniform(0.0, 30.0)))


def decided(ranked, selected, unpriced):
    return ([c.key for c in ranked], [c.score for c in ranked],
            [c.key for c in selected], [c.key for c in unpriced])


# --------------------------------------------------------------- decide
@pytest.mark.parametrize("case", range(6))
def test_decide_budget_conservation(case):
    vals, budget = pool_values(case)
    out = []
    for L in LIBS:
        pool = [mk_pool_candidate(L, i, b, c, u)
                for i, (b, c, u) in enumerate(vals)]
        ranked, selected, unpriced = pool_fleet(
            L, budget_gbhr=budget).decide(pool)
        assert sum(c.traits["compute_cost"] for c in selected) <= budget
        assert len(unpriced) == sum(1 for _, _, u in vals if u)
        out.append(decided(ranked, selected, unpriced))
    assert out[1] == out[0]


@pytest.mark.parametrize("case", range(4))
def test_decide_permutation_invariant(case):
    vals, _ = pool_values(100 + case)
    perm = np.random.RandomState(case).permutation(len(vals))
    out = []
    for L in LIBS:
        fleet = pool_fleet(L, budget_gbhr=5.0)
        pool = [mk_pool_candidate(L, i, b, c, u)
                for i, (b, c, u) in enumerate(vals)]
        a = decided(*fleet.decide(pool))
        b = decided(*fleet.decide([pool[i] for i in perm]))
        assert a == b
        out.append(a)
    assert out[1] == out[0]


def test_aging_promotes_starved_table():
    out = []
    for L in LIBS:
        fleet = pool_fleet(L, budget_gbhr=100.0, starvation_cycles=3)
        pool = [mk_pool_candidate(L, 0, benefit=1.0, cost=1.0),
                mk_pool_candidate(L, 1, benefit=100.0, cost=1.0)]
        fleet.skip_cycles[pool[0].table.table_id] = 3
        res = decided(*fleet.decide(pool))
        assert res[0][0][0] == pool[0].table.table_id
        out.append(res)
    assert out[1] == out[0]


def test_query_frequency_weights_benefit():
    out = []
    for L in LIBS:
        fleet = pool_fleet(L, budget_gbhr=100.0)
        cold = mk_pool_candidate(L, 0, benefit=10.0, cost=1.0)
        hot = mk_pool_candidate(L, 1, benefit=10.0, cost=1.0)
        tail = mk_pool_candidate(L, 2, benefit=1.0, cost=1.0)
        cold.stats.custom["query_freq"] = 0.1
        hot.stats.custom["query_freq"] = 50.0
        res = decided(*fleet.decide([cold, hot, tail]))
        assert res[0][0] == hot.key
        out.append(res)
    assert out[1] == out[0]


# ----------------------------------------------------------- fleet cycles
def test_starvation_bound():
    out = []
    for L in LIBS:
        clock, _, tables, fleet, append_small = mk_fleet_world(
            L, 4, n_files=10, budget=100.0, max_k=2, starvation_cycles=2)
        reps = []
        for _ in range(6):
            for t in tables[:2]:
                append_small(t, 14)
            reps.append(report(fleet.run_cycle()))
            clock.advance(1.0)
        assert fleet.max_skip_ever == fleet.starvation_cycles
        out.append((reps, fleet.totals(), dict(fleet.skip_cycles)))
    assert out[1] == out[0]
    assert sum(r["starved_served"] for r in out[1][0]) >= 2


def test_deferred_counts_as_unserved():
    out = []
    for L in LIBS:
        def factory(profile, activity=None, stats=None, L=L):
            return L.fleet.build_class_pipeline(
                profile, activity, stats=stats,
                scheduler=L.act.Scheduler(profile.target_file_mb * MB,
                                          offpeak_window=lambda: False))
        _, _, tables, fleet, _ = mk_fleet_world(
            L, 2, budget=100.0, starvation_cycles=3,
            pipeline_factory=factory)
        rep = report(fleet.run_cycle())
        assert rep["n_selected"] == 2 and len(rep["deferred_keys"]) == 2
        out.append((rep, fleet.totals(), dict(fleet.skip_cycles)))
    assert out[1] == out[0]


def test_classify_from_activity():
    out = []
    for L in LIBS:
        wl = L.wl
        tracker = wl.ActivityTracker(now_fn=wl.SimClock(start=4.0).now)
        evs = []
        for h in range(4):
            evs += [wl.QueryEvent(float(h), "write", "db/storm",
                                  files_written=40)] * 6
            evs += [wl.QueryEvent(float(h), "write", "db/steady",
                                  files_written=4),
                    wl.QueryEvent(float(h), "read", "db/steady")]
        evs += [wl.QueryEvent(0.0, "write", "db/bursty", files_written=2),
                wl.QueryEvent(1.0, "write", "db/bursty", files_written=2)]
        evs += [wl.QueryEvent(3.5, "write", "db/bursty",
                              files_written=6)] * 8
        evs += [wl.QueryEvent(3.5, "read", "db/bursty")] * 4
        evs += [wl.QueryEvent(0.5, "write", "db/cold", files_written=1)]
        tracker.record(evs)
        out.append({tid: L.fleet.classify_table(
            tracker.read_rate(tid), tracker.write_file_rate(tid),
            tracker.burstiness(tid))
            for tid in ("db/storm", "db/bursty", "db/cold", "db/steady")})
    assert out[1] == out[0]
    assert sorted(out[1].values()) == sorted(cs.FLEET_CLASSES)


def test_fleet_groups_by_class_and_applies_profiles():
    out = []
    for L in LIBS:
        clock, _, catalog = mk_world(L)
        append_small = small_appender(L)
        catalog.create_namespace("db", total_quota=100_000)
        hot = catalog.create_table("db", "hot", None)
        cold = catalog.create_table("db", "cold", None)
        for t in (hot, cold):
            t.now_fn = clock.now
            append_small(t, 12)
        clock.advance(4.0)
        tracker = L.wl.ActivityTracker(now_fn=clock.now)
        tracker.record([L.wl.QueryEvent(float(h), "read", hot.table_id)
                        for h in range(4)] * 2
                       + [L.wl.QueryEvent(float(h), "write", hot.table_id,
                                          files_written=4)
                          for h in range(4)])
        fleet = L.fleet.FleetScheduler(catalog, budget_gbhr=100.0,
                                       activity=tracker)
        rep = report(fleet.run_cycle())
        assert rep["class_counts"] == {"cold": 1, "steady": 1}
        assert {k[0] for k in rep["selected_keys"]} == {hot.table_id}
        out.append((rep, objects(catalog.store)))
    assert out[1] == out[0]


def test_tune_profile():
    out = []
    for L in LIBS:
        fleet = pool_fleet(L, budget_gbhr=10.0)

        def evaluate(profile):
            return (profile.min_small_files
                    + (0.0 if profile.scope == "hybrid" else 5.0)
                    + profile.target_file_mb / 512.0)

        best, res = fleet.tune_profile("steady", evaluate)
        assert fleet.profiles["steady"] == best and fleet.pipelines[
            "steady"].hybrid
        out.append((dataclasses.asdict(best), res.history, res.best_point,
                    res.best_objective, res.evaluations, res.rounds))
    assert out[1] == out[0]
    assert out[1][0]["min_small_files"] == 2


def test_service_requeue():
    out = []
    for L in LIBS:
        clock, _, catalog = mk_world(L)
        catalog.create_namespace("db", total_quota=100_000)
        t = catalog.create_table("db", "t0", None)
        t.now_fn = clock.now
        window = {"open": False}
        pipe = L.fleet.build_class_pipeline(
            L.fleet.ClassProfile("steady", scope="table", min_small_files=4),
            scheduler=L.act.Scheduler(
                512 * MB, offpeak_window=lambda w=window: w["open"]))
        svc = L.service.AutoCompService(
            catalog, pipe, L.service.ServiceConfig(interval_hours=1.0,
                                                   mode="after_write"),
            now_fn=clock.now)
        small_appender(L)(t, 10)
        catalog.notify_write(t)
        clock.advance(1.0)
        rep1 = report(svc.tick())
        window["open"] = True
        clock.advance(1.0)
        rep2 = report(svc.tick())
        assert len(rep1["deferred_keys"]) == 1 and rep2["files_removed"] > 0
        out.append((rep1, rep2, svc.totals(), objects(catalog.store)))
    assert out[1] == out[0]


# ------------------------------------------------------- the bench's fleet
@functools.lru_cache(maxsize=None)
def readme_fleet(pkg):
    """The README's fleet run through chip_smoke.py's reproduction of
    ``bench_fleet.py``: 48 tables, 3 cycles, budget 6, retention."""
    L = JAX if pkg == "jax" else TORCH
    fspec = L.wl.FleetSpec(n_tables=48, tables_per_db=6, seed=0)
    fleet, gen, per_cycle = cs.storm_fleet(L, fspec, cycles=3,
                                           budget_gbhr=6.0)
    return ([(report(r), before, after) for r, before, after in per_cycle],
            fleet.totals(), gen.total_file_count())


def test_readme_fleet_run_equal():
    j, t = readme_fleet("jax"), readme_fleet("torch")
    assert t == j
    cycles, totals, _ = t
    assert totals["rows_dropped"] > 0 and totals["files_dropped"] > 0
    for rep, before, after in cycles:
        assert rep["spent_gbhr"] <= rep["budget_gbhr"]
        assert after < before


def test_fleet_reproduction_matches_the_bench():
    """chip_smoke.py's make_fleet / submit_retention_ops / storm_fleet give
    the numbers ``bench_fleet.run_fleet`` gives for the same run."""
    res = run_fleet(n_tables=48, cycles=3, seed=0, budget_gbhr=6.0,
                    retention=True)
    cycles, totals, final = readme_fleet("jax")
    assert final == res["fleet_file_count_final"]
    assert totals["rows_dropped"] == res["fleet_rows_dropped"]
    assert totals["files_removed"] == res["fleet_files_removed_total"]
    for (rep, _, after), row in zip(cycles, res["per_cycle"]):
        assert (after, rep["n_candidates"], rep["n_selected"],
                rep["spent_gbhr"], rep["files_removed"],
                rep["max_skip_cycles"], rep["class_counts"]) == (
            row["file_count"], row["candidates"], row["selected"],
            row["spent_gbhr"], row["files_removed"],
            row["max_skip_cycles"], row["class_counts"])


def test_2k_fleet_cycle_from_carried_catalog():
    """The JAX generator builds ``FleetSpec()``'s 2000 tables and one hour
    of traffic; the port gets the same fleet through ``load_catalog`` and
    the same events; one cycle in each selects alike."""
    clock = jwl.SimClock()
    store = jlst.InMemoryStore()
    cat = jlst.Catalog(store, now_fn=clock.now)
    gen = jwl.WorkloadGenerator(cat, jwl.WorkloadSpec(seed=0), clock)
    gen.setup_fleet(jwl.FleetSpec())
    events = gen.run_hour(substeps=1)
    tables = []
    for t in sorted(cat.tables(), key=lambda t: t.table_id):
        ns, name = t.table_id.split("/", 1)
        files = [dataclasses.asdict(f) for f in t.current_files()]
        tables.append(dict(namespace=ns, name=name,
                           partition_spec=t.meta.partition_spec,
                           properties=dict(t.meta.properties), files=files,
                           objects={f["path"]: store.get(f["path"])
                                    for f in files}))
    tclock = twl.SimClock(start=clock.now())
    tcat = tlst.Catalog(tlst.InMemoryStore(), now_fn=tclock.now)
    loaded = tlst.load_catalog(tcat, tables)
    assert len(loaded) == 2000
    assert [[dataclasses.asdict(f) for f in t.current_files()]
            for t in loaded] == [t["files"] for t in tables]

    reps = []
    for L, catalog, now in ((JAX, cat, clock.now), (TORCH, tcat, tclock.now)):
        tracker = L.wl.ActivityTracker(now_fn=now)
        tracker.record([L.wl.QueryEvent(*dataclasses.astuple(e))
                        for e in events])
        fleet = L.fleet.FleetScheduler(catalog, budget_gbhr=12.0,
                                       activity=tracker)
        reps.append(fleet.run_cycle())
    j, t = reps
    assert t.selected_keys == j.selected_keys
    assert t.deferred_keys == j.deferred_keys
    assert t.class_counts == j.class_counts
    assert t.spent_gbhr == j.spent_gbhr
    assert (t.n_candidates, t.n_selected, t.files_removed, t.gbhr) == (
        j.n_candidates, j.n_selected, j.files_removed, j.gbhr)
    assert t.n_tables == 2000 and 0 < t.spent_gbhr <= 12.0


# --------------------------------------------- rewrite-delete via the fleet
def drop_even(rows, task):
    return rows[:, 0] % 2 == 0          # DROP even-leading rows


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two-pass"])
def test_fleet_rewrite_delete_identical_stores(fused):
    """tests/test_retention.py::TestFleetRewriteBitMatch's scenario in both
    packages: the same store objects, byte for byte, and rows_dropped."""
    out = []
    for L in LIBS:
        clock, store, cat = mk_world(L)
        t = cat.create_table("train", "corpus",
                             properties={"conflict_granularity": "table"})
        t.now_fn = clock.now
        w = L.data.TokenShardWriter(t, vocab=997, seed=3)
        for _ in range(3):
            w.trickle_append(n_files=6, tokens_per_file=3000)
        fleet = L.fleet.FleetScheduler(
            cat, budget_gbhr=100.0,
            profiles={"steady": L.fleet.ClassProfile(
                "steady", scope="table", min_small_files=1_000_000)},
            pipeline_factory=lambda p, activity=None, stats=None, L=L:
                L.fleet.build_class_pipeline(
                    p, activity, stats=stats,
                    scheduler=L.act.Scheduler(512 * MB, merge_fn=L.merge_fn,
                                              fused_filter=fused)))
        fleet.submit_delete(L.lst.PredicateDelete(
            "purge", row_predicate=drop_even, tables=(t.table_id,)))
        rep = report(fleet.run_cycle())
        assert rep["n_delete_candidates"] == 1 and rep["rows_dropped"] > 0
        assert not fleet.retention.has_pending()
        out.append((rep, fleet.totals(), objects(store)))
    assert out[1] == out[0]


# ------------------------------------------------ service and triggers
def small_world(L, seed=1, hours=1, n_databases=2, tables_per_db=3):
    clock, store, catalog = mk_world(L)
    gen = L.wl.WorkloadGenerator(catalog, L.wl.WorkloadSpec(
        n_databases=n_databases, tables_per_db=tables_per_db, seed=seed),
        clock)
    gen.setup()
    for _ in range(hours):
        gen.run_hour()
    return clock, store, catalog, gen


def make_pipeline(L, scope, k):
    """``benchmarks/workload_sim.py::make_pipeline``; the port's built the
    same way."""
    if L is JAX:
        return workload_sim.make_pipeline(scope, k)
    c, target = L.core, workload_sim.TARGET
    return c.AutoCompPipeline(
        stats=c.StatsCollector(target),
        traits=(c.FileCountReductionTrait(), c.FileEntropyTrait(),
                c.ComputeCostTrait()),
        trait_ctx=c.TraitContext(target_file_bytes=target),
        ranker=c.MoopRanker({"file_count_reduction": 0.7,
                             "compute_cost": 0.3}),
        scheduler=L.act.Scheduler(target), scope=c.Scope.TABLE,
        hybrid=(scope == "hybrid"), top_k=k)


def test_periodic_service_fires_on_interval():
    out = []
    for L in LIBS:
        clock, store, catalog, gen = small_world(L)
        svc = L.service.AutoCompService(
            catalog, make_pipeline(L, "table", k=5),
            L.service.ServiceConfig(interval_hours=2.0), clock.now)
        reps = []
        for _ in range(4):
            gen.run_hour()
            rep = svc.tick()
            reps.append(None if rep is None else report(rep))
        assert sum(r is not None for r in reps) == 2
        assert svc.totals()["files_removed"] > 0
        out.append((reps, svc.totals(), objects(store)))
    assert out[1] == out[0]


def test_optimize_after_write_hook_marks_dirty():
    out = []
    for L in LIBS:
        _, _, catalog, gen = small_world(L)
        hook = L.triggers.OptimizeAfterWriteHook(catalog)
        gen.run_hour()
        dirty = hook.drain_dirty()
        assert dirty and not hook.drain_dirty()
        out.append(sorted(dirty))
    assert out[1] == out[0]


def test_optimize_after_write_hook_fires_on_policy():
    """The hook's immediate variant: a threshold policy over observed
    traits fires on the same tables in both packages."""
    out = []
    for L in LIBS:
        _, _, catalog, gen = small_world(L)
        pipe = make_pipeline(L, "table", k=50)

        def observe(c, pipe=pipe):
            pipe.stats.observe(c)
            c.traits.update({"file_count": float(c.stats.file_count)})
        fired = []
        hook = L.triggers.OptimizeAfterWriteHook(
            catalog, policy=L.core.ThresholdPolicy("file_count", 100.0),
            observe_fn=observe,
            immediate_fn=lambda c, fired=fired: fired.append(c.key))
        gen.run_hour()
        assert hook.fired and fired
        out.append((hook.fired, fired, sorted(hook.drain_dirty())))
    assert out[1] == out[0]


def test_periodic_trigger():
    out = []
    for L in LIBS:
        clock = L.wl.SimClock()
        trig = L.triggers.PeriodicTrigger(1.5, clock.now)
        seen = []
        for _ in range(8):
            clock.advance(0.5)
            seen.append(trig.should_fire())
            if seen[-1]:
                trig.mark_fired()
        out.append(seen)
    assert out[1] == out[0]
    assert sum(out[1]) == 3


def test_after_write_mode_only_processes_dirty():
    out = []
    for L in LIBS:
        clock, store, catalog, gen = small_world(L)
        svc = L.service.AutoCompService(
            catalog, make_pipeline(L, "table", k=50),
            L.service.ServiceConfig(interval_hours=1.0, mode="after_write"),
            clock.now)
        gen.run_hour()
        rep = svc.tick()
        assert rep is not None and rep.selected_keys
        out.append((report(rep), svc.totals(), objects(store)))
    assert out[1] == out[0]


# ------------------------------------------------------ fleet/corpus, small
def test_small_corpus_fleet_identical_stores():
    """chip_smoke.py's fleet/corpus harness at 6 tables of 2000-token
    shards, a fifth of each stream's files per write, 3 sim-hours: the
    same reports and store objects, byte for byte, in both packages. (At
    4 tables the delete's one target is a cold table that never takes a
    write, so no rewrite-delete would run.)"""
    out = []
    drop = cs.gdpr_rows(0.05)
    for L in LIBS:
        cf = cs.CorpusFleet(L, L.merge_fn, n_tables=6, tokens_per_shard=2000,
                            factor=0.2, seed=0, selectivity=0.05)
        reps = [report(r) for r in cf.run(3, drop)]
        out.append((reps, cf.fleet.totals(), objects(cf.store),
                    [dataclasses.astuple(s) for s in cf.streams]))
    assert out[1] == out[0]
    reps, totals = out[1][0], out[1][1]
    assert totals["files_removed"] > 0 and totals["rows_dropped"] > 0
    assert all(r["spent_gbhr"] <= r["budget_gbhr"] for r in reps)
