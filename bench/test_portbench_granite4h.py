"""Granite-4.0-H-Small's plain reference
(``reference/granite_moe_hybrid.py``) against the program at a smoke size
on the host, on seeded f32 weights, and the ``g4h-decode`` cell driven
end to end there.

Tolerances: the port and the reference compute the same f32 arithmetic in
other orders (the SSD's chunked sums against the sequential recurrence,
blockwise online softmax against one softmax, einsums over other
layouts, the routed sum over other orders), so their logits agree to f32
rounding, ~1e-6 of their scale; 1e-4 leaves room for that and is three
orders of magnitude under what a dropped token, a misrouted one or a
state read one position off moves (~1e-1). The SSD against the
recurrence is compared in f64, where the two orders agree to ~1e-15;
1e-12 leaves room for that. Through the slot engine the state table is
held in bf16 (its resident dtype), so the served tokens are held by the
cell's check (``decode_gap``) at the smoke limit of
``test_portbench_cells``, 0.05.
"""

import contextlib
import importlib.util
import json
import pathlib
import time

import numpy as np
import pytest
import torch

from portbench import cli, faults, granite4h, registry
from reference import granite_moe_hybrid
from repro_torch.models.common import tree_map

BENCH = pathlib.Path(__file__).resolve().parent
CFG = json.loads((BENCH / "configs" / "granite-4.0-h-small.json").read_text())
# the published period's order at 6 layers: Mamba-2, attention every third
SMALL = {"num_hidden_layers": 6,
         "layer_types": ["mamba", "mamba", "attention",
                         "mamba", "mamba", "attention"],
         "hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 2, "mamba_n_heads": 8, "mamba_d_head": 16,
         "mamba_d_state": 16, "mamba_chunk_size": 8,
         "num_local_experts": 8, "num_experts_per_tok": 3,
         "intermediate_size": 16, "shared_intermediate_size": 32,
         "vocab_size": 512}
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
    w = granite4h.draw_weights(cfg, seed, torch.device("cpu"))
    granite4h.check_layout(cfg, w)
    return tree_map(lambda t: t.float(), w)


def tokens(cfg, shape, seed=0):
    return torch.randint(0, cfg["vocab_size"], shape,
                         generator=torch.Generator().manual_seed(seed))


def port_logits(cfg, weights, tok):
    from repro_torch.models import transformer
    return transformer.forward(granite4h.port_config(cfg), weights,
                               {"tokens": tok}, "encode")[0]


def ref_logits(cfg, weights, tok):
    return granite_moe_hybrid.logits(
        cfg, weights, list(tok), [torch.arange(tok.shape[1])] * tok.shape[0])


def assert_close(got, want):
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= TOL * scale


def test_config_is_the_published_one():
    from repro_torch.configs import get_config

    pc = granite4h.port_config(CFG)
    assert pc == get_config("granite-4.0-h-small")
    assert CFG["reduced"] == {}
    assert round(pc.param_count() / 1e9, 2) == 32.21
    assert round(pc.active_param_count() / 1e9, 2) == 8.80


@pytest.mark.parametrize("length", [5, 16, 21],
                         ids=["under-a-chunk", "whole-chunks", "ragged"])
def test_prefill_logits_match_the_reference(length):
    """Chunks of 8: a prompt inside one chunk, two whole chunks, and two
    whole chunks and a ragged third."""
    cfg = small_cfg()
    w = f32_weights(cfg)
    tok = tokens(cfg, (2, length), seed=length)
    assert_close(list(port_logits(cfg, w, tok)), ref_logits(cfg, w, tok))


@pytest.mark.parametrize("chunk", [4, 7, 21, 64])
def test_ssd_scan_is_the_sequential_recurrence(chunk):
    """21 positions, 4 heads in 2 groups: chunks that divide nothing,
    one, and one longer than the sequence."""
    from repro_torch.models import ssm

    g = torch.Generator().manual_seed(chunk)
    b, s, h, p, groups, n = 2, 21, 4, 3, 2, 5

    def rand(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)
    x, bm, cm = rand(b, s, h, p), rand(b, s, groups, n), rand(b, s, groups, n)
    dt = torch.rand(b, s, h, generator=g, dtype=torch.float64) * 0.5
    a = -torch.rand(h, generator=g, dtype=torch.float64) * 3
    y, last = ssm.ssd_scan(x, dt, a, bm, cm, chunk)
    state = torch.zeros(b, h, p, n, dtype=torch.float64)
    for t in range(s):
        bt = bm[:, t].repeat_interleave(h // groups, 1)
        ct = cm[:, t].repeat_interleave(h // groups, 1)
        state = state * torch.exp(dt[:, t] * a)[..., None, None] \
            + (dt[:, t, :, None] * x[:, t])[..., None] * bt[:, :, None]
        assert torch.allclose(y[:, t], torch.einsum("bhpn,bhn->bhp", state,
                                                    ct), atol=1e-12)
    assert torch.allclose(last, state, atol=1e-12)


def prefill_then_decode(cfg, w, tok, s0):
    """The prefill step's cache (held in f32 here) over the first ``s0``
    tokens, grown and read by decode steps token by token: every step's
    logits, and the reference's full forward at those positions."""
    from repro_torch.launch import serve
    from repro_torch.models import common, transformer
    from repro_torch.train import step as step_lib

    pc = granite4h.port_config(cfg)
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
    """A ragged prefill of 19 (two chunks and 3), then 11 decode steps."""
    cfg = small_cfg()
    w = f32_weights(cfg)
    assert_close(*prefill_then_decode(cfg, w, tokens(cfg, (2, 30), 1), 19))


def test_slot_engine_serves_the_reference_tokens(monkeypatch):
    """``generate(stream="slots")`` over prompts of their own lengths,
    three requests into two slots: the third is admitted into a freed
    row, which held its last occupant's KV and recurrent state; after
    admission every leaf of the row is the new request's slice. Each
    served token's logit lies within the smoke limit of the reference's
    best at its position (the slot table holds bf16)."""
    from repro_torch.launch import serve

    cfg = small_cfg()
    pc, w = granite4h.port_config(cfg), f32_weights(cfg)
    rows = []
    admit = serve._SlotStep.admit

    def spy(self, fn, slc, slot):
        before = {k: v[:, slot].clone() for k, v in self.cache.items()}
        admit(self, fn, slc, slot)
        rows.append((before, {k: v[:, slot].clone()
                              for k, v in self.cache.items()}, slc))
    monkeypatch.setattr(serve._SlotStep, "admit", spy)
    lens = np.array([9, 17, 12], np.int32)
    prompts = tokens(cfg, (3, 17), seed=2).numpy().astype(np.int32)
    out = serve.generate(pc, w, prompts, max_new=6, prompt_lens=lens,
                         stream="slots", slots=2)
    assert serve._generate_slots.last_stats["admissions"] == 3
    before, after, slc = rows[2]
    assert set(after) == {"k", "v", "ssm_conv", "ssm_state"}
    for k in after:
        assert not torch.equal(before[k], after[k]), k
        assert torch.equal(after[k], slc[k][:, 0].to(after[k].dtype)), k
    for i, n in enumerate(lens):
        seq = torch.as_tensor(np.concatenate([prompts[i, :n], out[i, :-1]]))
        ref = granite_moe_hybrid.logits(cfg, w, [seq],
                                        [torch.arange(n - 1, n - 1 + 6)])[0]
        served = torch.as_tensor(out[i]).long()
        gap = ref.max(-1).values - ref.gather(-1, served[:, None])[:, 0]
        assert float(gap.max()) <= 0.05


def test_a_router_skewed_to_one_expert_drops_nothing(monkeypatch):
    """Every token of every layer routed to expert 0 first (a large
    shared direction in the embedding that expert 0's router column
    reads; the layers' outputs at their plain 1/sqrt(fan-in) scale, so
    that direction stays the residual stream's), where a capacity
    dispatch would keep 19 of 40 rows: the port still matches the
    reference in prefill and in decode."""
    from repro_torch.models import moe

    cfg = small_cfg(init={"embed_std": 0.75, "out_gain": 1.0})
    w = f32_weights(cfg, seed=5)
    u = torch.randn(64, generator=torch.Generator().manual_seed(9))
    u /= u.norm()
    w["embed"] += 40 * u
    for stack in ("layers", "attn_layers"):
        w[stack]["moe"]["router"][:, :, 0] = 10 * u
    picks = []
    route = moe.route

    def spy(c, router, xt):
        gate, sel = route(c, router, xt)
        picks.append(sel[:, 0])
        return gate, sel
    monkeypatch.setattr(moe, "route", spy)
    tok = tokens(cfg, (1, 40), seed=4)
    assert_close(list(port_logits(cfg, w, tok)), ref_logits(cfg, w, tok))
    assert len(picks) == 6 and all((p == 0).all() for p in picks)
    assert moe.capacity(granite4h.port_config(cfg), 40) == 19 < 40
    picks.clear()
    assert_close(*prefill_then_decode(cfg, w, tok, 30))
    assert len(picks) == 6 * 10 and all((p == 0).all() for p in picks)


def test_fp8_control_departs():
    cfg = small_cfg()
    w = f32_weights(cfg)
    tok = tokens(cfg, (1, 40), seed=6)
    a = ref_logits(cfg, w, tok)[0]
    b = granite_moe_hybrid.logits(cfg, w, list(tok), [torch.arange(40)],
                                  granite_moe_hybrid.Precision("fp8"))[0]
    err = float((a - b).abs().max() / a.square().mean().sqrt())
    # far above f32 rounding (~1e-6), and no fault of the arithmetic
    assert 1e-3 < err < 5.0


def run(trace=False, seconds=0.3):
    bench = registry.benchmark()
    return cli.run_cell(bench, registry.cell("g4h-decode", bench),
                        2 ** 31 + 11, seconds, trace, torch.device("cpu"),
                        time.perf_counter(), overrides=SMOKE)


NEW_METRICS = ("mfu.g4h", "moe_row_use.g4h", "ssm_state_x.g4h")


def test_smoke_traced_run_reads_every_new_metric():
    """Rows used are top-k over experts (3 / 8). The decode update makes
    an f32 copy of the bf16 state and the bf16 new state, 4 + 2 bytes an
    element, against the bf16 state and conv rows it reads: 8 heads x 16
    x 16 state elements and 3 x 160 conv elements a row."""
    out = run(trace=True)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert all(m.get(k) is not None for k in NEW_METRICS), m
    assert m["moe_row_use.g4h"] == pytest.approx(37.5)
    state, conv = 8 * 16 * 16, 3 * 160
    assert m["ssm_state_x.g4h"] == pytest.approx(
        6 * state / (2 * (state + conv)))
    assert 0 < m["mfu.g4h"] < 100
    for k in ("tokens_per_step.decode", "step_ms.decode",
              "device_idle.decode", "step_host_ms.decode",
              "launch_idle_share.decode", "queue_ms.decode"):
        assert m.get(k) is not None, k


def test_check_catches_an_altered_token():
    with faults.plant("alter_token"):
        out = run()
    assert not out["correct"], out["checks"]


@contextlib.contextmanager
def stale_recurrent_rows():
    """Admission writes a request's KV slice but leaves the slot's
    Mamba-2 row as its last occupant left it."""
    from repro_torch.models import registry as model_registry

    admit = model_registry.StateStore.admit_row

    def stale(self, state, row, slot, **kw):
        new = admit(self, state, row, slot, **kw)
        return {k: state[k] if k.startswith("ssm_") else v
                for k, v in new.items()}
    model_registry.StateStore.admit_row = stale
    try:
        yield
    finally:
        model_registry.StateStore.admit_row = admit


def test_check_catches_a_stale_recurrent_row():
    with stale_recurrent_rows():
        out = run()
    assert not out["correct"], out["checks"]


def _work():
    spec = importlib.util.spec_from_file_location(
        "bench_work_hybrid", BENCH / "metrics" / "_work_hybrid.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_work_counts_by_hand():
    """Three layers (two Mamba-2, one attention), d 2, 1 attention head
    of 2, 1 KV head; Mamba-2 of 2 heads of 2 (inner 4), state 3, 1 group
    (conv width 4 + 6 = 10), conv 2; 4 experts of width 1, top 2, a
    shared width of 3; vocab 7."""
    cfg = {"hidden_size": 2, "num_attention_heads": 1,
           "num_key_value_heads": 1, "mamba_n_heads": 2, "mamba_d_head": 2,
           "mamba_d_state": 3, "mamba_n_groups": 1, "mamba_expand": 2,
           "mamba_d_conv": 2, "num_local_experts": 4,
           "num_experts_per_tok": 2, "intermediate_size": 1,
           "shared_intermediate_size": 3, "num_hidden_layers": 3,
           "layer_types": ["mamba", "attention", "mamba"], "vocab_size": 7}
    w = _work()
    # in_proj 2 x (4 + 10 + 2), out_proj 4 x 2, conv 2 x 10, 2 x 2 x 3
    assert w.mamba_flops(cfg) == 2 * 32 + 2 * 8 + 2 * 20 + 4 * 12
    # q, k, v, o: 2 x 2 each
    assert w.attn_proj_flops(cfg) == 2 * 16
    # router 2 x 4; 2 chosen of 3 x 2 x 1 and a shared 3 x 2 x 3
    assert w.moe_flops(cfg) == 2 * 8 + 2 * (12 + 18)
    one = 2 * w.mamba_flops(cfg) + w.attn_proj_flops(cfg) \
        + 3 * w.moe_flops(cfg) + 2 * 14
    # a key: 1 attention layer x 4 x d
    assert w.decode_flops(cfg, 4) == one + 8 * 4
    want = w.decode_flops(cfg, 4) + w.decode_flops(cfg, 5)
    assert w.decoded_flops(cfg, [(3, 3)]) == want
