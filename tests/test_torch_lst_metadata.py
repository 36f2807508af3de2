"""The table layer's metadata file (``repro_torch.lst.files.TableMetadata.
serialize``), on the host: each snapshot's JSON is encoded once and the
file is built from the kept fragments, so its bytes must stay those of
``json.dumps(dataclasses.asdict(meta))`` after every kind of commit, after
expiry and after a snapshot is replaced, and every store object must equal
the JAX package's for the same operations. Under ``repro_torch.obs`` the
counters ``lst.meta.snapshots_written`` and ``lst.meta.snapshots_encoded``
show that a commit encodes its own snapshot, not the table's history.
"""

import dataclasses
import functools
import json
import sys
import threading

import pytest

import repro.lst as jlst
import repro.lst.workload as jwl
import repro_torch.lst as tlst
import repro_torch.lst.workload as twl
from repro_torch import obs

PKGS = {"jax": (jlst, jwl), "torch": (tlst, twl)}
PROPS = {"conflict_granularity": "partition", "owner": "ingest",
         "target_file_bytes": 536870912, "ratio": 0.1}
STEPS = ("create", "appends", "scoped_rewrite", "delete", "stale_base",
         "expire", "appends_after_expiry")


@pytest.fixture(autouse=True)
def fresh():
    obs.disable()
    obs.clear()
    yield
    obs.disable()
    obs.clear()


def as_dumped(meta) -> bytes:
    return json.dumps(dataclasses.asdict(meta)).encode()


def new_table(lst, wl):
    clock = wl.SimClock()
    store = lst.InMemoryStore()
    cat = lst.Catalog(store, now_fn=clock.now)
    t = cat.create_table("lake", "events", partition_spec="region",
                         properties=PROPS)
    return t, store, clock


def data_files(lst, clock, tag, n, part):
    return [lst.DataFile(path=f"lake/events/data/{tag}-{i}.parquet",
                         size_bytes=1000 + 17 * i, num_rows=10 + i,
                         partition=part, created_at=clock.now(),
                         min_key=i, max_key=i + 5)
            for i in range(n)]


def steps(lst, t, clock):
    """The seeded sequence, step by step: yields each step's name once it
    is committed."""
    yield "create"
    for i in range(50):
        t.append(data_files(lst, clock, f"a{i}", 1 + i % 3,
                            "eu" if i % 2 else "us"))
        clock.advance(5 / 3600)
    yield "appends"
    eu = [f for f in t.current_files() if f.partition == "eu"]
    t.rewrite(eu, data_files(lst, clock, "merged", 1, "eu"), scope="eu")
    clock.advance(0.01)
    yield "scoped_rewrite"
    us = [f for f in t.current_files() if f.partition == "us"][:4]
    t.delete_files(us, scope="us")
    clock.advance(0.01)
    yield "delete"
    txn = t.new_transaction()
    txn.append_files(data_files(lst, clock, "late", 2, "us"))
    t.append(data_files(lst, clock, "first", 1, "eu"))
    clock.advance(0.01)
    txn.commit()                        # its base moved: CAS retry, rebase
    assert t.cas_retries == 1
    yield "stale_base"
    assert t.expire_snapshots(5) > 0
    assert len(t.meta.snapshots) == 5
    yield "expire"
    for i in range(7):
        t.append(data_files(lst, clock, f"b{i}", 2, "us"))
        clock.advance(5 / 3600)
    yield "appends_after_expiry"


def objects(store):
    return {p: store.get(p) for p in store.list("")}


@functools.lru_cache(maxsize=None)
def history(pkg_name):
    """{step: (serialize(), the dataclass dumped whole, the newest
    metadata object in the store, every store object)} of one package."""
    lst, wl = PKGS[pkg_name]
    t, store, clock = new_table(lst, wl)
    out = {}
    for step in steps(lst, t, clock):
        newest = store.get(f"{t.table_id}/metadata/v{t.meta.version}.json")
        out[step] = (t.meta.serialize(), as_dumped(t.meta), newest,
                     objects(store))
    return out


@pytest.mark.parametrize("step", STEPS)
def test_serialize_is_the_dataclass_dumped_whole(step):
    got, whole, newest, _ = history("torch")[step]
    assert got == whole
    assert newest == whole              # what the commit wrote
    assert json.loads(got)["properties"] == PROPS


@pytest.mark.parametrize("step", STEPS)
def test_store_objects_equal_the_reference(step):
    assert history("torch")[step][3] == history("jax")[step][3]


def commit_n(n, obs_on):
    t, store, clock = new_table(tlst, twl)
    if obs_on:
        obs.enable()
    for i in range(n):
        t.append(data_files(tlst, clock, f"c{i}", 1, "us"))
        clock.advance(5 / 3600)
    return t, store, clock


@pytest.mark.parametrize("n", [1, 12, 200])
def test_each_commit_encodes_its_own_snapshot(n):
    t, _, _ = commit_n(n, obs_on=True)
    c = obs.counters()
    assert c["lst.meta.snapshots_encoded"] == n
    assert c["lst.meta.snapshots_written"] == n * (n + 1) // 2
    assert t.meta.serialize() == as_dumped(t.meta)


def test_counters_off_leave_the_bytes_alone():
    _, s_on, _ = commit_n(30, obs_on=True)
    obs.disable()
    _, s_off, _ = commit_n(30, obs_on=False)
    assert s_on.metrics.snapshot() == s_off.metrics.snapshot()
    assert objects(s_on) == objects(s_off)


def test_expiry_drops_fragments_and_encodes_only_the_kept():
    t, _, clock = commit_n(40, obs_on=False)
    obs.enable()
    t.expire_snapshots(5)
    c = obs.counters()
    assert c["lst.meta.snapshots_written"] == 5
    assert c["lst.meta.snapshots_encoded"] == 5
    assert len(t.meta._fragments) == 5
    t.append(data_files(tlst, clock, "d", 1, "eu"))
    assert obs.counters()["lst.meta.snapshots_encoded"] == 6
    assert t.meta.serialize() == as_dumped(t.meta)


def test_a_replaced_snapshot_is_encoded_anew():
    """A snapshot object swapped for another (here a summary changed
    through ``dataclasses.replace``) never keeps its old fragment."""
    t, _, _ = commit_n(10, obs_on=False)
    before = t.meta.serialize()
    old = t.meta.snapshots[3]
    t.meta.snapshots[3] = dataclasses.replace(
        old, summary={**old.summary, "note": "restated"})
    after = t.meta.serialize()
    assert after != before and after == as_dumped(t.meta)
    assert b'"note": "restated"' in after


def test_threads_committing_at_once_keep_the_bytes():
    """Eight writers append to one table at once, with the interpreter
    switching threads as often as it can: the kept fragments follow the
    table's lock, so the last metadata file is the whole dump and every
    commit encoded its own snapshot once."""
    t, store, clock = new_table(tlst, twl)
    obs.enable()
    errors = []

    def writer(w):
        try:
            for i in range(25):
                t.append(data_files(tlst, clock, f"w{w}-{i}", 1, "eu"))
        except Exception as e:          # surfaced by the assert below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=writer, args=(w,))
                   for w in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in threads)
    assert len(t.meta.snapshots) == 200
    newest = store.get(f"{t.table_id}/metadata/v{t.meta.version}.json")
    assert newest == as_dumped(t.meta)
    assert obs.counters()["lst.meta.snapshots_encoded"] == 200
