"""The reader of ``graph_step_share.decode``: the program's graph replays
over the window's decode steps, None on a program that records no
``serve.graph.*`` counter (a parent without the graph, or any run on the
host, where the step is never captured)."""

import pytest

from portbench import registry
from portbench.records import Records
from repro_torch import obs
from test_portbench_spans import recorder, traced  # noqa: F401


def read(rec):
    return registry.metric_reader("graph_step_share.decode").read(rec)


def test_no_graph_counters_read_nothing():
    rec = traced()
    rec.add("decode_steps", 128)
    assert read(rec) is None
    obs.count("attn.pairs_computed", 10)
    assert read(rec) is None


def test_share_from_planted_counters():
    rec = traced()
    rec.add("decode_steps", 128)
    obs.count("serve.graph.captures")
    for _ in range(127):
        obs.count("serve.graph.replays")
    assert read(rec) == pytest.approx(100.0 * 127 / 128)


def test_a_capture_without_replays_reads_zero():
    rec = traced()
    rec.add("decode_steps", 4)
    obs.count("serve.graph.captures")
    assert read(rec) == 0.0


def test_no_decode_steps_read_nothing():
    obs.count("serve.graph.replays", 3)
    assert read(traced()) is None
    assert read(Records(tracing=False)) is None


def test_host_smoke_run_reports_no_share():
    """On the host the slot engine never captures, so a traced smoke run
    of the cell leaves the share out of its line."""
    from test_portbench_cells import run

    obs.disable()
    obs.clear()
    out = run("serve-decode", trace=True)
    assert out["correct"], out["checks"]
    assert "graph_step_share.decode" not in out["metrics"]
    assert "tokens_per_step.decode" in out["metrics"]
