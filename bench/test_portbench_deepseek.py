"""DeepSeek-V2-Lite's plain reference (``reference/deepseek_v2.py``)
against the program at a smoke size on the host, on seeded f32 weights,
and the ``v2lite-decode`` cell driven end to end there.

Tolerances: the port and the reference compute the same f32 arithmetic in
other orders (blockwise online softmax against one softmax, einsums over
other layouts, the routed sum over other orders), so their logits agree to
f32 rounding, ~1e-6 of their scale; 1e-4 leaves room for that and is
three orders of magnitude under what one dropped or misrouted token moves
(the skewed router's capacity dispatch would move logits by ~1e-1).
Through the slot engine the cache is held in bf16 (its resident dtype), so
the served tokens are held by the cell's check (``decode_gap``) at the smoke
limit of ``test_portbench_cells``.
"""

import importlib.util
import json
import math
import pathlib
import time

import numpy as np
import pytest
import torch

from portbench import cli, deepseek, faults, registry
from reference import deepseek_v2
from repro_torch.models.common import tree_map

BENCH = pathlib.Path(__file__).resolve().parent
CFG = json.loads((BENCH / "configs" / "deepseek-v2-lite.json").read_text())
SMALL = {"num_hidden_layers": 3, "hidden_size": 64, "intermediate_size": 128,
         "num_attention_heads": 4, "num_key_value_heads": 4,
         "kv_lora_rank": 16, "qk_rope_head_dim": 8, "qk_nope_head_dim": 8,
         "v_head_dim": 16, "n_routed_experts": 8, "num_experts_per_tok": 3,
         "moe_intermediate_size": 16, "vocab_size": 512,
         "init": {"embed_std": 1.0, "head_std": 0.375}}
SMOKE = {"config": SMALL,
         "mix": {"requests_per_call": 3, "slots": 2, "max_new": 6,
                 "sample_requests": 3, "limits": {"decode_gap": 0.05},
                 "prompt_len": {"median": 12, "min": 4, "max": 24}}}
TOL = 1e-4


def small_cfg(**over):
    cfg = cli._merge(CFG, SMALL)
    cfg.update(over)
    return cfg


def f32_weights(cfg, seed=3):
    w = deepseek.draw_weights(cfg, seed, torch.device("cpu"))
    deepseek.check_layout(cfg, w)
    return tree_map(lambda t: t.float(), w)


def tokens(cfg, shape, seed=0):
    return torch.randint(0, cfg["vocab_size"], shape,
                         generator=torch.Generator().manual_seed(seed))


def port_logits(cfg, weights, tok):
    from repro_torch.models import transformer
    return transformer.forward(deepseek.port_config(cfg), weights,
                               {"tokens": tok}, "encode")[0]


def ref_logits(cfg, weights, tok):
    return deepseek_v2.logits(cfg, weights, list(tok),
                              [torch.arange(tok.shape[1])] * tok.shape[0])


def assert_close(got, want):
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= TOL * scale


def test_config_is_the_published_one():
    pc = deepseek.port_config(CFG)
    from repro_torch.configs import get_config
    assert pc == get_config("deepseek-v2-lite")
    assert CFG["reduced"] == {}
    assert round(pc.param_count() / 1e9, 2) == 15.71


def test_prefill_logits_match_the_reference():
    cfg = small_cfg()
    w = f32_weights(cfg)
    tok = tokens(cfg, (2, 40))
    assert_close(list(port_logits(cfg, w, tok)), ref_logits(cfg, w, tok))


def prefill_then_decode(cfg, w, tok, s0):
    """The prefill step's cache (held in f32 here) over the first ``s0``
    tokens, grown and read by decode steps token by token: every step's
    logits, and the reference's full forward at those positions."""
    from repro_torch.launch import serve
    from repro_torch.models import common, transformer
    from repro_torch.train import step as step_lib

    pc = deepseek.port_config(cfg)
    b, total = tok.shape
    want = ref_logits(cfg, w, tok)
    dt = common.COMPUTE_DTYPE
    common.COMPUTE_DTYPE = torch.float32
    try:
        logits, cache = step_lib.make_prefill_step(pc)(
            w, {"tokens": tok[:, :s0]})
    finally:
        common.COMPUTE_DTYPE = dt
    got = [logits]
    cache = serve.grow_cache(cache, transformer.abstract_cache(
        pc, b, total, dtype=torch.float32))
    decode = step_lib.make_decode_step(pc, total)
    for p in range(s0, total - 1):
        logits, cache = decode(w, cache, {
            "tokens": tok[:, p:p + 1], "pos": torch.full((b,), p)})
        got.append(logits)
    return list(torch.stack(got, 1)), [x[s0 - 1:total - 1] for x in want]


def test_prefill_then_decode_matches_the_full_forward():
    cfg = small_cfg()
    w = f32_weights(cfg)
    assert_close(*prefill_then_decode(cfg, w, tokens(cfg, (2, 30), 1), 22))


def test_slot_engine_serves_the_reference_tokens():
    """``generate(stream="slots")`` over ragged prompts, fewer slots than
    requests: each served token's logit lies within the smoke limit of
    the reference's best at its position (the slot table holds bf16)."""
    from repro_torch.launch import serve

    cfg = small_cfg()
    pc, w = deepseek.port_config(cfg), f32_weights(cfg)
    lens = np.array([9, 17, 12], np.int32)
    prompts = tokens(cfg, (3, 17), seed=2).numpy().astype(np.int32)
    out = serve.generate(pc, w, prompts, max_new=6, prompt_lens=lens,
                         stream="slots", slots=2)
    assert serve._generate_slots.last_stats["admissions"] == 3
    for i, n in enumerate(lens):
        seq = torch.as_tensor(np.concatenate([prompts[i, :n], out[i, :-1]]))
        ref = deepseek_v2.logits(cfg, w, [seq],
                                 [torch.arange(n - 1, n - 1 + 6)])[0]
        served = torch.as_tensor(out[i]).long()
        gap = ref.max(-1).values - ref.gather(-1, served[:, None])[:, 0]
        assert float(gap.max()) <= 0.05


def test_yarn_frequencies_and_scale_are_the_closed_form():
    """Rope dim 64, base 1e4, 4096 positions, beta 32 and 1: the
    correction range is dims 10 to 23 (``yarn_find_correction_range``),
    so dims 0-10 keep their frequency, dims 23-31 are divided by 40 and a
    linear ramp runs between; the softmax scale is 192 ** -0.5 times
    (0.1 x 0.707 x ln 40 + 1) ** 2."""
    from repro_torch.models import common

    pc = deepseek.port_config(CFG)
    base = 1.0 / 10000.0 ** (np.arange(0, 64, 2) / 64)
    ramp = np.clip((np.arange(32) - 10) / 13, 0, 1)
    want = base / 40 * ramp + base * (1 - ramp)
    assert (ramp[:11] == 0).all() and (ramp[23:] == 1).all()
    for got in (common.yarn_freqs(64, 10000.0, 40.0, 4096, 32.0, 1.0),
                deepseek_v2.yarn_inv_freq(CFG, "cpu")):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert pc.softmax_scale == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert deepseek_v2.softmax_scale(CFG) == pytest.approx(pc.softmax_scale,
                                                           rel=1e-12)
    assert round(m * m, 4) == 1.5896


def test_a_router_skewed_to_one_expert_drops_nothing(monkeypatch):
    """Every token of every MoE layer routed to expert 0 first (a large
    shared direction in the embedding that expert 0's router column
    reads), where the capacity dispatch would keep 19 of 40 rows: the
    port still matches the reference in prefill and in decode."""
    from repro_torch.models import moe

    cfg = small_cfg()
    w = f32_weights(cfg, seed=5)
    u = torch.randn(64, generator=torch.Generator().manual_seed(9))
    u /= u.norm()
    w["embed"] += 40 * u
    w["layers"]["moe"]["router"][:, :, 0] = 10 * u
    picks = []
    route = moe.route

    def spy(c, router, xt):
        gate, sel = route(c, router, xt)
        picks.append(sel[:, 0])
        return gate, sel
    monkeypatch.setattr(moe, "route", spy)
    tok = tokens(cfg, (1, 40), seed=4)
    assert_close(list(port_logits(cfg, w, tok)), ref_logits(cfg, w, tok))
    assert len(picks) == 2 and all((p == 0).all() for p in picks)
    assert moe.capacity(deepseek.port_config(cfg), 40) == 19 < 40
    picks.clear()
    assert_close(*prefill_then_decode(cfg, w, tok, 30))
    assert len(picks) == 2 * 10 and all((p == 0).all() for p in picks)


def test_fp8_control_departs():
    cfg = small_cfg()
    w = f32_weights(cfg)
    tok = tokens(cfg, (1, 40), seed=6)
    a = ref_logits(cfg, w, tok)[0]
    b = deepseek_v2.logits(cfg, w, list(tok), [torch.arange(40)],
                           deepseek_v2.Precision("fp8"))[0]
    err = float((a - b).abs().max() / a.square().mean().sqrt())
    assert 1e-3 < err < 1.0


def run(trace=False, seconds=0.3):
    bench = registry.benchmark()
    return cli.run_cell(bench, registry.cell("v2lite-decode", bench),
                        2 ** 31 + 11, seconds, trace, torch.device("cpu"),
                        time.perf_counter(), overrides=SMOKE)


NEW_METRICS = ("moe_row_use.v2lite", "mla_kv_x.v2lite", "mfu.v2lite")


def test_smoke_traced_run_reads_every_new_metric():
    """Rows used are top-k over experts (3 / 8), and the K/V built per
    latent byte is heads x (nope + rope + v dims) over (latent + rope
    dims): 4 x 32 / 24."""
    out = run(trace=True)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert all(m.get(k) is not None for k in NEW_METRICS), m
    assert m["moe_row_use.v2lite"] == pytest.approx(37.5)
    assert m["mla_kv_x.v2lite"] == pytest.approx(4 * 32 / 24)
    assert 0 < m["mfu.v2lite"] < 100
    for k in ("tokens_per_step.decode", "step_ms.decode",
              "device_idle.decode", "step_host_ms.decode",
              "launch_idle_share.decode", "queue_ms.decode"):
        assert m.get(k) is not None, k


def test_check_catches_an_altered_token():
    with faults.plant("alter_token"):
        out = run()
    assert not out["correct"], out["checks"]


def _work():
    spec = importlib.util.spec_from_file_location(
        "bench_work_mla_moe", BENCH / "metrics" / "_work_mla_moe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_work_counts_by_hand():
    """Two layers (one dense, one MoE), d 2, 1 head, kv_lora 3, rope 1,
    nope 2, v 2, 4 experts of width 1 (top 2, 1 shared), dense width 5,
    vocab 7."""
    cfg = {"hidden_size": 2, "num_attention_heads": 1, "q_lora_rank": None,
           "kv_lora_rank": 3, "qk_nope_head_dim": 2, "qk_rope_head_dim": 1,
           "v_head_dim": 2, "intermediate_size": 5, "moe_intermediate_size": 1,
           "n_routed_experts": 4, "num_experts_per_tok": 2,
           "n_shared_experts": 1, "num_hidden_layers": 2,
           "first_k_dense_replace": 1, "vocab_size": 7}
    w = _work()
    # wq 2x3, wkv_a 2x4, absorb 2x3 and 3x2, wo 2x2
    assert w.attn_params(cfg) == 6 + 8 + 6 + 6 + 4
    assert w.ffn_params(cfg, False) == 3 * 2 * 5
    # router 2x4, 2 chosen + 1 shared SwiGLUs of 3 x 2 x 1
    assert w.ffn_params(cfg, True) == 8 + 3 * 6
    assert w.token_params(cfg) == 2 * 30 + 30 + 26 + 14
    # a key: 2 layers x 1 head x (2 x kv_lora + rope) x 2
    assert w.decode_flops(cfg, 4) == 2 * 130 + 28 * 4
    want = w.decode_flops(cfg, 4) + w.decode_flops(cfg, 5)
    assert w.decoded_flops(cfg, [(3, 3)]) == want
