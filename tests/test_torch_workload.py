"""The workload simulator of the port (``repro_torch.lst.workload``) against
the JAX package's, on the CPU, tolerance 0.

Both generators run from the same seed: the quickstart's CAB-like workload
(``WorkloadSpec(n_databases=3, tables_per_db=4, seed=42)``,
``examples/quickstart.py``) for three hours, and a 48-table
``FleetSpec`` fleet for two. Every ``QueryEvent`` field (the CAS retries of
the concurrent commit waves included), every table's ``DataFile`` list and
every store object must be equal. ``ActivityTracker`` and ``CostModel``
must give equal floats on the same inputs, and ``LocalFSStore`` the same
listing and bytes for the same operations.
"""

import dataclasses
import functools

import pytest

import repro.lst as jlst
import repro.lst.workload as jwl
import repro_torch.lst as tlst
import repro_torch.lst.workload as twl

PKGS = {"jax": (jlst, jwl), "torch": (tlst, twl)}
SCENARIOS = ("quickstart", "fleet48")


@functools.lru_cache(maxsize=None)
def run(pkg_name, scenario):
    lst, wl = PKGS[pkg_name]
    clock = wl.SimClock()
    store = lst.InMemoryStore()
    cat = lst.Catalog(store, now_fn=clock.now)
    if scenario == "quickstart":
        gen = wl.WorkloadGenerator(cat, wl.WorkloadSpec(
            n_databases=3, tables_per_db=4, seed=42), clock)
        gen.setup()
        hours = 3
    else:
        gen = wl.WorkloadGenerator(cat, wl.WorkloadSpec(seed=0), clock)
        gen.setup_fleet(wl.FleetSpec(n_tables=48))
        hours = 2
    hourly = [gen.run_hour() for _ in range(hours)]
    return dict(
        gen=gen,
        events=[[dataclasses.astuple(e) for e in h] for h in hourly],
        streams=[dataclasses.astuple(s) for s in gen.streams],
        files={t.table_id: [dataclasses.asdict(f)
                            for f in t.current_files()]
               for t in cat.tables()},
        objects={p: store.get(p) for p in store.list("")},
        metrics=store.metrics.snapshot(),
        totals=(gen.total_file_count(),
                gen.small_file_fraction(512 << 20), clock.now()))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_event_streams_equal(scenario):
    j, t = run("jax", scenario), run("torch", scenario)
    assert t["streams"] == j["streams"]
    assert t["events"] == j["events"]
    assert sum(len(h) for h in t["events"]) > 0
    # the concurrent commit waves collided and retried in both
    if scenario == "quickstart":
        assert any(e[7] > 0 for h in t["events"] for e in h)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_tables_and_store_equal(scenario):
    j, t = run("jax", scenario), run("torch", scenario)
    assert t["files"] == j["files"]
    assert t["objects"] == j["objects"]
    assert t["metrics"] == j["metrics"]
    assert t["totals"] == j["totals"]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_activity_tracker_equal(scenario):
    """Both trackers fed the JAX generator's events: every rate and the
    burstiness of every table are the same floats."""
    events = [e for h in run("jax", scenario)["events"] for e in h]
    now = run("jax", scenario)["totals"][2]
    out = {}
    for name, (_, wl) in PKGS.items():
        tr = wl.ActivityTracker(now_fn=lambda: now)
        tr.record([wl.QueryEvent(*e) for e in events])
        ids = sorted({e[2] for e in events})
        out[name] = {tid: (tr.read_rate(tid), tr.write_rate(tid),
                           tr.write_file_rate(tid), tr.burstiness(tid))
                     for tid in ids}
    assert out["torch"] == out["jax"]
    assert any(v[3] > 0.0 for v in out["torch"].values())


def test_activity_tracker_window_prunes_equal():
    """Events older than the window leave both trackers alike."""
    out = {}
    for name, (_, wl) in PKGS.items():
        clock = wl.SimClock()
        tr = wl.ActivityTracker(now_fn=clock.now, window_hours=2.0)
        for h in range(6):
            clock.advance(1.0)
            tr.record([wl.QueryEvent(clock.now(), "write", "db/t",
                                     files_written=h + 1)] * (h % 3 + 1)
                      + [wl.QueryEvent(clock.now(), "read", "db/t")])
        out[name] = (tr.read_rate("db/t"), tr.write_rate("db/t"),
                     tr.write_file_rate("db/t"), tr.burstiness("db/t"),
                     tr.read_rate("db/none"), tr.burstiness("db/none"))
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_cost_model_equal(scenario):
    """``read_latency_s`` over each table's files, default and custom
    model parameters."""
    files = run("jax", scenario)["files"]
    out = {}
    for name, (lst, wl) in PKGS.items():
        models = (wl.CostModel(), wl.CostModel(open_ms=2.5,
                                               plan_ms_per_file=1.3,
                                               read_gb_per_s=2.0,
                                               base_ms=10.0))
        out[name] = [m.read_latency_s([lst.DataFile(**f) for f in fs])
                     for m in models for fs in files.values()]
    assert out["torch"] == out["jax"]


def test_local_fs_store_equal(tmp_path):
    """The same puts, gets, lists and deletes under one root in each
    package give the same listing, bytes and metrics."""
    out = {}
    for name, (lst, _) in PKGS.items():
        store = lst.LocalFSStore(str(tmp_path / name))
        for i in range(6):
            store.put(f"db/t{i % 2}/data/f{i:03d}.bin", bytes([i]) * (i + 3))
        store.put("db/t0/metadata/v1.json", b'{"v": 1}')
        got = [store.get(p) for p in store.list("db/t0")]
        store.delete("db/t1/data/f003.bin")
        out[name] = dict(
            listing=store.list(""), sub=store.list("db/t1"), got=got,
            exists=(store.exists("db/t1/data/f003.bin"),
                    store.exists("db/t1/data/f005.bin")),
            objects={p: store.get(p) for p in store.list("")},
            count=store.count("db/t0"),
            metrics=store.metrics.snapshot())
    assert out["torch"] == out["jax"]
    assert len(out["torch"]["listing"]) == 6
