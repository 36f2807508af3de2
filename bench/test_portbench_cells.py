"""Every cell driven end to end on the host at a smoke size, without the
harness's look for a card: a sound run comes out correct, and a run with a
fault planted in the program underneath (``portbench.faults``) comes out
not correct. The limits here are the smoke size's own; the cells' limits
in ``bench/mixes`` come from readings on the card at the cells' sizes."""

import time

import pytest
import torch

from portbench import cli, faults, registry

MODEL = {"num_hidden_layers": 2, "hidden_size": 64, "intermediate_size": 128,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
         "vocab_size": 512}
SMOKE = {
    "serve-decode": {
        "config": MODEL,
        "mix": {"requests_per_call": 3, "slots": 2, "max_new": 6,
                "sample_requests": 3, "limits": {"decode_gap": 0.05},
                "prompt_len": {"median": 12, "min": 4, "max": 24}}},
    "serve-prefill": {
        "config": MODEL,
        "mix": {"prompt_len": {"min": 4, "max": 40, "count": 8}, "warm": 2,
                "sample_requests": 4, "limits": {"prefill_logit_err": 0.2}}},
    "compact-cdc": {
        "config": {"corpus": {"target_file_bytes": 40 * 4108}},
        "mix": {"shards_per_commit": 2, "shard_tokens": 1000,
                "pool_shards": 20, "commits_per_table": 6,
                "warm_shards": 3}},
}
FAULTS = [("serve-decode", "alter_token"), ("serve-prefill", "alter_logits"),
          ("compact-cdc", "swap_chunks"), ("compact-cdc", "flip_token")]


def run(cell, trace=False, seconds=0.3):
    bench = registry.benchmark()
    return cli.run_cell(bench, registry.cell(cell, bench), 2 ** 31 + 11,
                        seconds, trace, torch.device("cpu"),
                        time.perf_counter(),
                        overrides=SMOKE[cell])


@pytest.mark.parametrize("cell", sorted(SMOKE))
def test_sound_run_is_correct(cell):
    out = run(cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) <= {m["name"] for m in
                                   registry.benchmark()["per_layer"]}
    assert len(out["breakdown"]["idle_gaps"]) <= 10
    assert list(out)[-2] == "checks"          # last in the printed line


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_is_caught(cell, fault):
    with faults.plant(fault):
        out = run(cell)
    assert not out["correct"], out["checks"]


def test_end_to_end_metrics_reported():
    out = run("serve-prefill")
    assert set(out["metrics"]) == {"ttft_p90_ms", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
