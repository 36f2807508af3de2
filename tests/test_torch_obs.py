"""The span-and-counter recorder, ``repro_torch.obs``, and what the
instrumented paths emit for the benchmark's readers, on the host at smoke
sizes; and, on a CUDA card only, that a span around a synchronised
kernel contains the kernel's interval in the profiler's trace (the two
share one clock). The outputs with recording on equal those with it off.

On the card: ``PYTHONPATH=src python -m pytest --noconftest -p
no:cacheprovider -s -q tests/test_torch_obs.py`` (the suite's conftest
imports JAX, which that machine does not have).
"""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import obs
from repro_torch.configs import smoke_config
from repro_torch.data import packing, shards
from repro_torch.launch import serve
from repro_torch.launch.train import build_autocomp
from repro_torch.lst import Catalog, InMemoryStore
from repro_torch.lst.files import DataFile
from repro_torch.models import common, transformer


@pytest.fixture(autouse=True)
def fresh():
    obs.disable()
    obs.clear()
    yield
    obs.disable()
    obs.clear()


def by_name(name):
    return [s for s in obs.spans() if s.name == name]


def kineto_interval(prof, pick):
    """(start, end) in the profiler's nanoseconds of the events ``pick``
    keeps, from first start to last end."""
    iv = []
    for e in prof.profiler.kineto_results.events():
        if pick(e):
            t0 = e.start_ns() if hasattr(e, "start_ns") \
                else int(e.start_us() * 1000)
            dur = e.duration_ns() if hasattr(e, "duration_ns") \
                else int(e.duration_us() * 1000)
            iv.append((t0, t0 + dur))
    assert iv
    return min(a for a, _ in iv), max(b for _, b in iv)


# ---------------------------------------------------------------- recorder

def test_off_by_default_records_nothing_and_shares_the_noop():
    assert not obs.on()
    assert obs.span("a") is obs.span("b", req=3)
    with obs.span("a") as handle:
        obs.count("c", 5)
    assert handle is None
    assert obs.begin("d") is None and obs.record("e", 1, 2) is None
    assert obs.spans() == [] and obs.counters() == {}


def test_on_when_enabled_and_while_profiled_then_off():
    obs.enable()
    with obs.span("enabled"):
        obs.count("n", 2)
    obs.disable()
    assert not obs.on()
    with profile(activities=[ProfilerActivity.CPU]):
        assert obs.on()
        with obs.span("profiled"):
            obs.count("n", 3)
    assert not obs.on()
    with obs.span("after"):
        obs.count("n", 100)
    assert [s.name for s in obs.spans()] == ["enabled", "profiled"]
    assert obs.counters() == {"n": 5}


def test_parents_nest_and_req_is_carried():
    obs.enable()
    with obs.span("a"):
        with obs.span("b", req=7) as b:
            obs.record("c", 10, 20, req=7)
            obs.record("d", 11, 12, parent=b)
        m = obs.record("e", 30, 40)
        obs.record("f", 31, 32, parent=m)
    with obs.span("g"):
        pass
    got = [(s.name, s.parent, s.req) for s in obs.spans()]
    assert got == [("a", -1, None), ("b", 0, 7), ("c", 1, 7), ("d", 1, None),
                   ("e", 0, None), ("f", 4, None), ("g", -1, None)]
    assert all(s.end >= s.start for s in obs.spans())


def test_an_exception_closes_what_it_left_open():
    obs.enable()
    with pytest.raises(ValueError):
        with obs.span("outer"):
            obs.begin("left_open")
            raise ValueError
    with obs.span("next"):
        pass
    outer, left, nxt = obs.spans()
    assert outer.end is not None and left.end is None
    assert nxt.parent == -1


def test_parents_are_per_thread():
    obs.enable()

    def worker():
        with obs.span("thread"):
            pass
    with obs.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    assert by_name("thread")[0].parent == -1


def test_buffer_is_bounded_and_clear_resets(monkeypatch):
    monkeypatch.setattr(obs, "MAX_SPANS", 4)
    obs.enable()
    with obs.span("p") as p:
        for i in range(10):
            with obs.span("s", req=i):
                pass
    assert p is not None and len(obs.spans()) == 4
    assert [s.req for s in obs.spans()[1:]] == [0, 1, 2]
    obs.count("k")
    obs.clear()
    assert obs.spans() == [] and obs.counters() == {}
    with obs.span("after"):
        pass
    assert [(s.name, s.parent) for s in obs.spans()] == [("after", -1)]


def test_a_span_cleared_while_open_is_no_parent():
    obs.enable()
    with obs.span("old"):
        obs.clear()
        with obs.span("new"):
            pass
    assert [(s.name, s.parent) for s in obs.spans()] == [("new", -1)]


def test_stamps_are_on_the_profilers_clock():
    a = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bracket"):
            with obs.span("inside"):
                sum(range(1000))
    b = time.time_ns()
    (s,) = by_name("inside")
    assert a <= s.start <= s.end <= b
    lo, hi = kineto_interval(prof, lambda e: e.name() == "bracket")
    assert lo <= s.start and s.end <= hi


def test_span_contains_its_kernel_on_the_card():
    """On the card, under a profiler of the card's activity only (as the
    benchmark's traced runs record): the span around a launch and its
    synchronise contains the kernel's interval. Prints the offsets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType

    x = torch.randn(4096, 4096, device="cuda")
    x @ x
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with obs.span("clock"):
            x @ x
            torch.cuda.synchronize()
    (s,) = by_name("clock")
    lo, hi = kineto_interval(
        prof, lambda e: e.device_type() == DeviceType.CUDA)
    print(f"\nclock: {torch.cuda.get_device_name(0)}; the kernel starts "
          f"{(lo - s.start) / 1e3:.1f} us after the span and ends "
          f"{(s.end - hi) / 1e3:.1f} us before its end "
          f"(span {(s.end - s.start) / 1e3:.1f} us, kernel "
          f"{(hi - lo) / 1e3:.1f} us)")
    assert s.start <= lo <= hi <= s.end


# ------------------------------------------------- the instrumented paths

def test_slot_engine_emits_a_step_per_decode_step():
    cfg = smoke_config("granite-3-8b")
    params = transformer.init_params(cfg, seed=0, device="cpu")
    gen = np.random.default_rng(0)
    lens = np.array([5, 9, 3], np.int32)
    prompts = gen.integers(0, cfg.vocab, (3, 9)).astype(np.int32)
    kw = dict(max_new=4, prompt_lens=lens, stream="slots", slots=2)
    off = serve.generate(cfg, params, prompts, **kw)
    off_stats = dict(serve._generate_slots.last_stats)
    obs.enable()
    on = serve.generate(cfg, params, prompts, **kw)
    stats = serve._generate_slots.last_stats
    assert np.array_equal(on, off)
    assert stats["decode_steps"] == off_stats["decode_steps"]
    steps = by_name("serve.step")
    assert len(steps) == stats["decode_steps"]
    sp = obs.spans()
    for name in ("serve.step.launch", "serve.step.wait"):
        kids = by_name(name)
        assert len(kids) == len(steps)
        assert all(sp[k.parent].name == "serve.step" for k in kids)
    for name in ("serve.queue", "serve.prefill", "serve.admit"):
        assert sorted(s.req for s in by_name(name)) == [0, 1, 2], name
    queue = {s.req: s for s in by_name("serve.queue")}
    for p in by_name("serve.prefill"):
        assert p.end <= queue[p.req].end


def cdc_table(n_commits=4):
    store = InMemoryStore()
    cat = Catalog(store)
    table = cat.create_table("lake", "cdc")
    gen = np.random.default_rng(1)
    for c in range(n_commits):
        raw = shards.encode_shard(gen.integers(0, 500, 3000, dtype=np.int32))
        path = f"{table.table_id}/data/{c}.toks"
        store.put(path, raw)
        table.append([DataFile(path=path, size_bytes=len(raw),
                               num_rows=3000)])
    return cat, table


def test_table_commit_emits_its_three_phases():
    obs.enable()
    _, table = cdc_table(2)
    commits = by_name("lst.commit")
    assert len(commits) == 2 and len(by_name("shards.encode")) == 2
    sp = obs.spans()
    i = sp.index(commits[1])
    assert [s.name for s in sp if s.parent == i] == [
        "lst.commit.rebase", "lst.commit.manifest", "lst.commit.metadata"]


def test_cycle_emits_its_phases_and_wall_s_is_its_length():
    cat, _ = cdc_table()
    auto = build_autocomp(cat, None, target_bytes=64 << 10, device="cpu")
    packing.reset_stage_seconds()
    obs.enable()
    rep = auto.run_cycle(cat)
    assert rep.files_removed > 0
    sp = obs.spans()
    (cycle,) = by_name("autocomp.cycle")
    assert rep.wall_s == (cycle.end - cycle.start) * 1e-9
    ci = sp.index(cycle)
    assert [s.name for s in sp if s.parent == ci] == [
        "autocomp.observe", "autocomp.orient", "autocomp.decide",
        "autocomp.act"]
    act = sp.index(by_name("autocomp.act")[0])
    merges = by_name("act.merge")
    assert merges and all(m.parent == act for m in merges)
    assert any(s.name == "lst.commit" and s.parent == act for s in sp)
    # the stages' spans and STAGE_SECONDS come from the same readings
    for k in packing.STAGES:
        total = sum(s.end - s.start for s in by_name("merge." + k)) * 1e-9
        assert total == pytest.approx(packing.STAGE_SECONDS[k], abs=1e-9)
    for m in merges:
        kids = [s for s in sp if s.parent == sp.index(m)]
        assert [s.name for s in kids if s.name.startswith("merge.")] == [
            "merge." + k for k in packing.STAGES]
        assert m.start <= kids[0].start and kids[-1].end <= m.end


def test_cycle_report_without_recording():
    cat, _ = cdc_table()
    auto = build_autocomp(cat, None, target_bytes=64 << 10, device="cpu")
    rep = auto.run_cycle(cat)
    assert rep.files_removed > 0 and rep.wall_s > 0
    assert obs.spans() == []


def closed_form(sq, sk, causal, window):
    return sum(1 for i in range(sq) for j in range(sk)
               if (not causal or j <= i) and (not window or i - j < window))


@pytest.mark.parametrize("sq,sk,causal,window,block", [
    (8, 8, True, 0, 1024),          # one tile
    (10, 10, True, 0, 4),           # padded last tiles
    (12, 12, True, 5, 4),           # a window
    (6, 9, False, 0, 4),            # not causal, padded keys
    (9, 9, False, 3, 4),            # not causal, a window
])
def test_attention_counts_its_pairs(sq, sk, causal, window, block):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, sq, 4, 8, generator=gen)
    k = torch.randn(2, sk, 2, 8, generator=gen)
    v = torch.randn(2, sk, 2, 8, generator=gen)
    kw = dict(causal=causal, window=window, block_q=block, block_k=block)
    off = common.blockwise_attention(q, k, v, **kw)
    obs.enable()
    on = common.blockwise_attention(q, k, v, **kw)
    assert torch.equal(on, off)
    bq, bk = min(block, sq), min(block, sk)
    pad = lambda n, b: -(-n // b) * b                       # noqa: E731
    assert obs.counters() == {
        "attn.pairs_computed": 2 * 4 * pad(sq, bq) * pad(sk, bk),
        "attn.pairs_needed": 2 * 4 * closed_form(sq, sk, causal, window)}


def test_attention_pairs_with_an_offset():
    assert common.attention_pairs(3, 8, True, 0, q_offset=5) == \
        sum(min(5 + i, 7) + 1 for i in range(3))
    assert common.attention_pairs(4, 4, True, 2) == 1 + 2 + 2 + 2
