"""The yardstick's arithmetic on hand-worked cases: the FLOP counts, the
traffic's sizes, the trace's busy time and gaps, and the shard format's
reference."""

import importlib.util
import pathlib

import numpy as np
import pytest

from portbench import traffic, window
from portbench.records import Records, Trace
from reference import shards as ref

BENCH = pathlib.Path(__file__).resolve().parent
spec = importlib.util.spec_from_file_location("bench_work",
                                              BENCH / "metrics" / "_work.py")
work = importlib.util.module_from_spec(spec)
spec.loader.exec_module(work)

# one layer, d 2, 1 head of 2, 1 kv head, d_ff 3, vocab 5
TINY = {"num_hidden_layers": 1, "hidden_size": 2, "intermediate_size": 3,
        "num_attention_heads": 1, "num_key_value_heads": 1, "head_dim": 2,
        "vocab_size": 5}


def test_layer_params_by_hand():
    # wq 2x2, wo 2x2, wk 2x2, wv 2x2, gate/up 2x3, down 3x2
    assert work.layer_params(TINY) == 4 + 4 + 4 + 4 + 6 + 6 + 6


def test_prefill_counts_needed_pairs():
    # 3 tokens: linear 2*34*3; one logits row 2*2*5; pairs 1+2+3 = 6, each
    # 4 * layers * heads * head_dim = 8 FLOPs
    assert work.prefill_flops(TINY, 3) == 2 * 34 * 3 + 20 + 8 * 6


def test_decode_and_decoded():
    assert work.decode_flops(TINY, 4) == 2 * 34 + 20 + 8 * 4
    # a 3-token prompt, 3 new: the prefill's token, then tokens at 4 and 5
    # keys; the prefill itself is not counted
    want = work.decode_flops(TINY, 4) + work.decode_flops(TINY, 5)
    assert work.decoded_flops(TINY, [(3, 3)]) == want
    assert work.decoded_flops(TINY, [(3, 1)]) == 0


def test_window_starts_only_units_that_fit(monkeypatch):
    """Units of 4 s in a 10 s window: the third would end at 12 s, so two
    run and the window is 8 s; the first starts whatever its length."""
    now = [0.0]
    monkeypatch.setattr(window.time, "perf_counter", lambda: now[0])
    win = window.Window(10)
    for _ in win:
        now[0] += 4.0
    assert win.units == 2 and win.elapsed == 8.0
    win = window.Window(3)
    for _ in win:
        now[0] += 4.0
    assert win.units == 1 and win.elapsed == 4.0


def test_lengths_are_quantiles_in_a_seeded_order():
    spec = {"dist": "loguniform", "min": 256, "max": 4096}
    lens = traffic.lengths(spec, 4)
    want = [256 * 16 ** ((i + 0.5) / 4) for i in range(4)]
    assert lens.tolist() == [int(round(v)) for v in want]
    ln = traffic.lengths({"dist": "lognormal", "median": 768, "sigma": 0.6,
                          "min": 128, "max": 2048}, 25)
    assert ln[12] == 768 and ln.min() >= 128 and ln.max() == 2048
    a = traffic.rng(2 ** 31 + 5, 1, 0).permutation(8)
    assert (a == traffic.rng(2 ** 31 + 5, 1, 0).permutation(8)).all()
    assert not (a == traffic.rng(2 ** 31 + 6, 1, 0).permutation(8)).all()


def test_trace_busy_gaps_and_spans():
    ops = [("kernel", "a", 10, 20), ("memcpy", "c", 15, 30),
           ("kernel", "b", 50, 60), ("kernel", "a", 95, 120)]
    notes = [("window", 0, 100), ("cycle", 40, 70), ("commit", 70, 100)]
    t = Trace(ops, notes, (0, 100))
    assert t.busy_intervals() == [(10, 30), (50, 60), (95, 100)]
    assert t.busy_s() == pytest.approx(35e-9)
    assert t.op_seconds_within("cycle") == pytest.approx(10e-9)
    br = t.breakdown(["window", "cycle", "commit"])
    assert br["device_ops"][0] == ["a", pytest.approx(15e-9)]
    assert br["idle_gaps"][0] == ["commit", pytest.approx(35e-9)]
    assert [g[0] for g in br["idle_gaps"]] == ["commit", "cycle", "host"]


def test_records_spans():
    rec = Records()
    with rec.span("x"):
        pass
    with rec.span("x"):
        pass
    assert len(rec.spans["x"]) == 2 and rec.seconds("x") >= 0


def test_shard_format_and_plan():
    toks = np.arange(1500, dtype=np.int32)
    raw = ref.MAGIC + (1500).to_bytes(8, "little") \
        + np.concatenate([toks, np.zeros(548, np.int32)]).tobytes()
    assert (ref.decode(raw) == toks).all()
    assert ref.encoded_size(1500) == len(raw) == 12 + 4 * 2048
    bins = ref.plan_bins([("a", 50), ("b", 30), ("c", 30), ("d", 100),
                          ("e", 60)], target=100)
    # first fit decreasing, ties in listing order; d is not under target
    assert bins == [["e", "b"], ["a", "c"]]
    assert ref.gbhr(256e9, 8.0, 256e9) == 8.0
