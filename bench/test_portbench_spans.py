"""The readers of the program's own spans and counters
(``bench/metrics/_spans.py`` and the metrics built on it): each on
synthetic spans and a synthetic trace with a known answer, and each cell
at a smoke size on the host, traced, where every one of them must read a
number."""

import pytest

from portbench import registry
from portbench.records import Records, Trace
from repro_torch import obs
from test_portbench_cells import SMOKE, run

T0 = 1_800_000_000 * 10 ** 9          # an epoch stamp, as the profiler's
MS = 10 ** 6
SPAN_METRICS = {
    "serve-decode": ["step_ms.decode", "step_host_ms.decode",
                     "launch_idle_share.decode", "queue_ms.decode"],
    "compact-cdc": ["commit_ms.compact", "commit_idle_share.compact",
                    "control_plane_s.compact"],
    "serve-prefill": ["attn_pair_use.prefill"],
}


@pytest.fixture(autouse=True)
def recorder():
    obs.clear()
    obs.enable()
    yield
    obs.disable()
    obs.clear()


def traced(busy_ms=(), window_ms=(0, 100)):
    """Records with a trace of ``window_ms`` whose card is busy over the
    intervals ``busy_ms`` (ms from ``T0``)."""
    rec = Records(tracing=True)
    ops = [("kernel", "k", T0 + int(a * MS), T0 + int(b * MS))
           for a, b in busy_ms]
    rec.trace = Trace(ops, [], (T0 + window_ms[0] * MS,
                                T0 + window_ms[1] * MS))
    return rec


def span(name, a_ms, b_ms, parent=None, req=None):
    return obs.record(name, T0 + int(a_ms * MS), T0 + int(b_ms * MS),
                      parent=parent, req=req)


def read(name, rec):
    return registry.metric_reader(name).read(rec)


def helpers():
    return registry.metric_reader("step_ms.decode")._spans


def test_window_spans_are_clipped_and_kept_by_index():
    span("before", -20, -10)
    span("straddles", -5, 10)
    p = span("inside", 20, 30)
    span("child", 22, 24, parent=p)
    span("after", 100, 120)
    obs.begin("open")
    sp = helpers().window_spans(traced())
    assert {s.name: (s.start - T0, s.end - T0) for s in sp.values()} == {
        "straddles": (0, 10 * MS), "inside": (20 * MS, 30 * MS),
        "child": (22 * MS, 24 * MS)}
    assert sp[3].parent == 2 and sp[2].name == "inside"


def test_self_time_and_idle_inside_spans():
    h = helpers()
    p = span("p", 0, 60)
    for a, b in ((10, 20), (15, 30), (50, 70)):
        span("c", a, b, parent=p)
    sp = h.window_spans(traced())
    assert h.self_time(sp, 0) == 60 * MS - (20 + 10) * MS
    rec = traced(busy_ms=[(10, 20), (50, 70)])
    assert h.idle_within(rec, [s for s in sp.values() if s.name == "c"]) \
        == (10 + 0 + 0) * MS
    assert h.idle_within(rec, [sp[0]]) == 60 * MS - 20 * MS


def test_untraced_or_unrecorded_reads_nothing():
    rec = Records(tracing=False)
    for names in SPAN_METRICS.values():
        for name in names:
            assert read(name, rec) is None
            assert read(name, traced()) is None


def test_decode_step_readers():
    for a, n, wait in ((0, 10, 4), (20, 30, 5), (60, 20, 18)):
        s = span("serve.step", a, a + n)
        span("serve.step.launch", a, a + 1, parent=s)
        span("serve.step.wait", a + n - wait, a + n, parent=s)
    for i, q in enumerate((5, 9, 7)):
        span("serve.queue", 0, q, req=i)
    rec = traced(busy_ms=[(0.5, 1)])
    assert read("step_ms.decode", rec) == 20.0
    assert read("step_host_ms.decode", rec) == 6.0        # 6, 25, 2
    assert read("queue_ms.decode", rec) == 7.0
    # launches over 0-1, 20-21, 60-61 ms: idle but for 0.5-1
    assert read("launch_idle_share.decode", rec) == pytest.approx(2.5)


def test_commit_readers():
    for a, n in ((0, 1), (10, 2), (20, 3), (30, 6)):
        span("lst.commit", a, a + n)
    rec = traced(busy_ms=[(0.5, 11), (33, 50)])
    assert read("commit_ms.compact", rec) == 3.0
    # idle in commits: 0-0.5, 11-12, 20-23, 30-33 of 100 ms
    assert read("commit_idle_share.compact", rec) == pytest.approx(7.5)


def test_control_plane_leaves_out_only_merges_under_a_cycle():
    c = span("autocomp.cycle", 0, 50)
    act = span("autocomp.act", 10, 45, parent=c)
    span("act.merge", 20, 40, parent=act)
    span("act.merge", 60, 70)
    span("autocomp.cycle", 80, 90)
    assert read("control_plane_s.compact", traced()) \
        == pytest.approx(0.040)


def test_attention_pair_use():
    obs.count("attn.pairs_computed", 1000)
    obs.count("attn.pairs_needed", 339)
    assert read("attn_pair_use.prefill", traced()) == pytest.approx(33.9)


@pytest.mark.parametrize("cell", sorted(SMOKE))
def test_every_span_metric_reads_in_a_traced_smoke_run(cell):
    listed = {m["name"] for m in registry.per_layer(registry.benchmark(),
                                                    cell)}
    assert set(SPAN_METRICS[cell]) <= listed
    obs.disable()
    obs.clear()
    out = run(cell, trace=True)
    assert out["correct"], out["checks"]
    for name in SPAN_METRICS[cell]:
        assert out["metrics"][name]["value"] is not None, name
    if cell == "compact-cdc":
        inside = out["metrics"]["control_plane_s.compact"]["value"]
        outside = out["metrics"]["outside_merge_s.compact"]["value"]
        assert inside == pytest.approx(outside, rel=0.25, abs=0.05)
