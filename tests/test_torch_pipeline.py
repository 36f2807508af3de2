"""The port's ``DataPipeline`` against the JAX package's, on the CPU,
tolerance 0.

The same token-shard table -- written by each package's own writer, or
written by the JAX package and carried across with
``lst/interop.py::load_table`` -- gives the same batches in both: the port
yields int32 tensors, the reference numpy arrays, with equal values,
shapes and order (the ``RandomState(seed)`` permutation), before and after
a compaction cycle. The prefetching path equals the plain one; it raises
an error of its thread to the consumer and stops its thread when the
consumer stops early. The default device is the card, and with no card it
raises.
"""

import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

import repro.data as jdata
import repro.lst as jlst
import repro.lst.compaction as jcomp
import repro.lst.workload as jwl
import repro_torch.data as tdata
import repro_torch.lst as tlst
import repro_torch.lst.compaction as tcomp
import repro_torch.lst.workload as twl

PKGS = {"jax": (jdata, jlst, jcomp, jwl, jdata.merge_shards_fn),
        "torch": (tdata, tlst, tcomp, twl,
                  functools.partial(tdata.merge_shards_fn, device="cpu"))}
SHAPES = [(2, 64, 1), (3, 100, 7), (1, 1000, 0)]   # batch, seq_len, seed


def make_table(pkg, vocab=500, seed=5, commits=2, n_files=5, tokens=2000):
    data, lst, _, wl, _ = PKGS[pkg]
    clock = wl.SimClock()
    cat = lst.Catalog(lst.InMemoryStore(), now_fn=clock.now)
    t = cat.create_table("train", "corpus",
                         properties={"conflict_granularity": "table"})
    t.now_fn = clock.now
    w = data.TokenShardWriter(t, vocab=vocab, seed=seed)
    for _ in range(commits):
        w.trickle_append(n_files=n_files, tokens_per_file=tokens)
    return t


def carried(jt):
    """The JAX-written table in the port, by ``load_table``."""
    files = [dataclasses.asdict(f) for f in jt.current_files()]
    objs = {f["path"]: jt.store.get(f["path"]) for f in files}
    cat = tlst.Catalog(tlst.InMemoryStore())
    return tlst.load_table(cat, "train", "corpus", files, objs,
                           properties={"conflict_granularity": "table"})


def compact(pkg, t, target=1 << 20):
    _, _, comp, _, merge_fn = PKGS[pkg]
    for task in comp.plan_table(t, target_bytes=target):
        assert comp.execute_task(t, task, merge_fn=merge_fn).success


def jax_batches(t, batch, seq, seed):
    return [(b["tokens"], b["labels"])
            for b in jdata.DataPipeline(t, batch, seq, seed=seed).batches()]


def port_batches(t, batch, seq, seed, prefetch=None):
    pipe = tdata.DataPipeline(t, batch, seq, seed=seed, device="cpu",
                              prefetch=prefetch or 2)
    it = pipe.prefetching_batches() if prefetch else pipe.batches()
    out = []
    for b in it:
        for k in ("tokens", "labels"):
            assert b[k].dtype == torch.int32 and b[k].device.type == "cpu"
            assert tuple(b[k].shape) == (batch, seq)
        out.append((b["tokens"].numpy().copy(), b["labels"].numpy().copy()))
    return out


def assert_same(got, want):
    assert len(got) == len(want) > 0
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt.dtype == wt.dtype and gt.shape == wt.shape
        assert np.array_equal(gt, wt) and np.array_equal(gl, wl)


@pytest.mark.parametrize("batch,seq,seed", SHAPES)
@pytest.mark.parametrize("source", ["own_writer", "load_table"])
def test_batches_equal_reference(source, batch, seq, seed):
    jt = make_table("jax")
    tt = make_table("torch") if source == "own_writer" else carried(jt)
    assert_same(port_batches(tt, batch, seq, seed),
                jax_batches(jt, batch, seq, seed))


@pytest.mark.parametrize("source", ["own_writer", "load_table"])
def test_batches_equal_reference_after_compaction(source):
    jt = make_table("jax", commits=4)
    tt = make_table("torch", commits=4) if source == "own_writer" \
        else carried(jt)
    compact("jax", jt)
    compact("torch", tt)
    assert tt.file_count() == jt.file_count() < 20
    assert_same(port_batches(tt, 2, 64, 3), jax_batches(jt, 2, 64, 3))
    pipe = tdata.DataPipeline(tt, 2, 64, device="cpu")
    list(pipe.batches())
    jpipe = jdata.DataPipeline(jt, 2, 64)
    list(jpipe.batches())
    assert pipe.files_scanned == jpipe.files_scanned == tt.file_count()


def test_batches_equal_numpy_packing():
    """Each batch is numpy's packing of the path-ordered stream, in the
    seeded permutation, independent of either pipeline."""
    t = make_table("torch")
    files = sorted(t.current_files(), key=lambda f: f.path)
    stream = np.concatenate([tdata.decode_shard(t.store.get(f.path))
                             for f in files])
    batch, seq = 3, 50
    per = batch * (seq + 1)
    slabs = stream[: stream.shape[0] // per * per].reshape(-1, batch, seq + 1)
    order = np.random.RandomState(4).permutation(len(slabs))
    got = port_batches(t, batch, seq, 4)
    assert_same(got, [(slabs[i][:, :-1], slabs[i][:, 1:]) for i in order])


@pytest.mark.parametrize("prefetch", [1, 2, 4])
def test_prefetching_equals_plain(prefetch):
    t = make_table("torch", seed=6)
    assert_same(port_batches(t, 2, 64, 2, prefetch=prefetch),
                port_batches(t, 2, 64, 2))


def test_empty_table_yields_nothing():
    for pkg in PKGS:
        t = make_table(pkg, commits=0)
        if pkg == "jax":
            assert jax_batches(t, 2, 64, 0) == []
        else:
            assert port_batches(t, 2, 64, 0) == []
            assert port_batches(t, 2, 64, 0, prefetch=2) == []


def _workers():
    return [th for th in threading.enumerate()
            if th is not threading.current_thread() and th.daemon]


def test_prefetch_early_stop_ends_the_thread():
    t = make_table("torch", commits=4)
    before = len(_workers())
    it = tdata.DataPipeline(t, 1, 16, device="cpu",
                            prefetch=1).prefetching_batches()
    next(it)
    next(it)
    it.close()
    assert len(_workers()) == before


def test_prefetch_raises_the_thread_s_error():
    t = make_table("torch")
    bad = t.current_files()[0]
    t.store.put(bad.path, b"not a shard")
    it = tdata.DataPipeline(t, 2, 64, device="cpu").prefetching_batches()
    with pytest.raises(AssertionError, match="not a token shard"):
        next(it)


def test_default_device_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = make_table("torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.DataPipeline(t, 2, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.DataPipeline(t, 2, 64, device="cuda:0")
    # the CPU is reachable only by asking for it
    assert len(list(tdata.DataPipeline(t, 2, 64, device="cpu").batches()))
