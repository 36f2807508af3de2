"""The port's serving launcher against the JAX package's, and the
reference's own serving properties held in the port.

Parity: ``repro_torch.launch.serve.generate`` and
``repro.launch.serve.generate`` on the same weights (the reference's
``init_params`` cast to f32, carried across by ``params_from_jax``) and
the same prompts give equal greedy tokens, for every decoding family's
smoke config, in each one-device mode: uniform and ragged batches, slot
streaming (with the int8 cache transfer), int8 and f8 storage, the int8
activation transport, the fan-in engine with eviction, and the paged
table. The fan-in engine's counters (admissions, evictions, requeues,
decode steps, the arbiter's longest wait, the pages) equal the
reference's too.

Properties: the classes of ``tests/test_serve.py`` (ragged continuous
batching, cache growth, sampling determinism, int8/f8 storage, slot
streaming, state-store bleed) and the single-device engine classes of
``tests/test_serve_fanin.py``, run on the port alone. Sampling is held
only for determinism: the port draws from a ``torch.Generator``, not from
``jax.random``. The paged + priority-eviction + int8-storage arm is held
to what its test states, equal to the unpaged int8 fan-in; the
reference's own run of that test fails, for a cause that is not the
pages (ROADMAP §3).
"""

from __future__ import annotations

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.configs import shapes as ref_shapes
from repro.launch import serve as ref_serve
from repro.models import transformer as ref_tf
from repro.train import step as ref_step
from repro_torch.configs import ARCH_IDS, get_config, shapes, smoke_config
from repro_torch.models import params_from_jax, registry, transformer
from repro_torch.launch import serve
from repro_torch.models.common import tree_leaves
from repro_torch.train import step as step_lib

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = ("granite-3-8b", "qwen3-moe-30b-a3b", "minicpm3-4b", "hymba-1.5b",
            "xlstm-125m")
ATTENTION = ("granite-3-8b", "qwen3-moe-30b-a3b", "minicpm3-4b")


def _prompts(cfg, b, s, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab, size=(b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    """Per arch: (reference cfg, reference f32 params, port cfg, port
    params), the port's carried from the reference's."""
    memo = {}

    def get(arch):
        if arch not in memo:
            rcfg = ref_smoke_config(arch)
            p = ref_tf.init_params(rcfg, jax.random.PRNGKey(1))
            p = jax.tree.map(lambda x: x.astype(jnp.float32)
                             if x.dtype == jnp.bfloat16 else x, p)
            cfg = smoke_config(arch)
            memo[arch] = (rcfg, p, cfg, params_from_jax(
                cfg, jax.tree.map(np.asarray, p), device="cpu"))
        return memo[arch]
    return get


@pytest.fixture(scope="module")
def dense(models):
    _, _, cfg, params = models("granite-3-8b")
    return cfg, params


# ---------------------------------------------------------------------------
# parity with the reference: greedy tokens, f32
# ---------------------------------------------------------------------------

LENS = np.array([5, 10, 8], np.int32)
PRIOS = np.array([1, 1, 0, 0], np.int32)
FANIN_LENS = np.array([7, 12, 9, 11], np.int32)

MODES = {
    "uniform": dict(),
    "ragged": dict(prompt_lens=LENS),
    "slots": dict(prompt_lens=LENS, stream="slots", slots=2),
    "slots_int8_transfer": dict(stream="slots", slots=2,
                                cache_transfer="int8"),
    "int8_storage": dict(prompt_lens=LENS, kv_storage="int8"),
    "f8_storage": dict(kv_storage="f8"),
    "int8_act": dict(act_transport="int8"),
    "fanin_evict": dict(prompt_lens=FANIN_LENS, workers=2, slots=2,
                        evict="priority", priorities=PRIOS),
    "fanin_oldest_int8": dict(prompt_lens=FANIN_LENS, workers=2, slots=2,
                              evict="oldest", kv_storage="int8",
                              cache_transfer="int8"),
    "paged": dict(prompt_lens=FANIN_LENS, workers=2, slots=2,
                  evict="priority", priorities=PRIOS, paged=True,
                  page_size=4),
    "paged_f8": dict(prompt_lens=FANIN_LENS, workers=2, paged=True,
                     kv_storage="f8"),
}

PARITY = [
    *[(a, "uniform") for a in FAMILIES],
    *[(a, "ragged") for a in ATTENTION],
    *[(a, "slots") for a in FAMILIES],
    ("granite-3-8b", "slots_int8_transfer"),
    ("hymba-1.5b", "slots_int8_transfer"),
    *[(a, "int8_storage") for a in ATTENTION],
    ("granite-3-8b", "f8_storage"), ("minicpm3-4b", "f8_storage"),
    ("granite-3-8b", "int8_act"), ("minicpm3-4b", "int8_act"),
    ("hymba-1.5b", "int8_act"), ("xlstm-125m", "int8_act"),
    ("granite-3-8b", "fanin_evict"), ("minicpm3-4b", "fanin_evict"),
    ("xlstm-125m", "fanin_evict"),
    ("granite-3-8b", "fanin_oldest_int8"),
    ("granite-3-8b", "paged"), ("qwen3-moe-30b-a3b", "paged"),
    ("minicpm3-4b", "paged_f8"),
]

STATS = ("admissions", "evictions", "requeues", "decode_steps",
         "max_wait_passes", "peak_live_pages", "page", "hbm_bytes_per_slot",
         "dense_hbm_bytes_per_slot")


@pytest.mark.parametrize("arch,mode", PARITY)
def test_greedy_tokens_equal_reference(arch, mode, models):
    rcfg, rp, cfg, tp = models(arch)
    kw = MODES[mode]
    b = len(kw["prompt_lens"]) if "prompt_lens" in kw else 3
    s0 = int(kw["prompt_lens"].max()) if "prompt_lens" in kw else 10
    prompts = _prompts(cfg, b, s0, seed=7)
    want = ref_serve.generate(rcfg, rp, prompts, max_new=6, **kw)
    got = serve.generate(cfg, tp, prompts, max_new=6, **kw)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert (got == want).all(), (got, want)
    if kw.get("workers", 1) > 1:
        w_st = ref_serve._generate_fanin.last_stats
        g_st = serve._generate_fanin.last_stats
        assert {k: g_st[k] for k in STATS if k in w_st} == \
            {k: w_st[k] for k in STATS if k in w_st}
    elif kw.get("stream") == "slots":
        w_st = ref_serve._generate_slots.last_stats
        g_st = serve._generate_slots.last_stats
        for k in ("admissions", "decode_steps"):
            assert g_st[k] == w_st[k], k


def test_moe_int8_act_decode_waits_for_expert_a2a(models):
    """The reference sends int8 MoE decode through ``expert_a2a``; so
    does the port, on one device too: its greedy tokens equal the
    reference's."""
    rcfg, rp, cfg, tp = models("qwen3-moe-30b-a3b")
    prompts = _prompts(cfg, 2, 8)
    want = ref_serve.generate(rcfg, rp, prompts, max_new=4,
                              act_transport="int8")
    got = serve.generate(cfg, tp, prompts, max_new=4, act_transport="int8")
    assert (got == want).all(), (got, want)


# ---------------------------------------------------------------------------
# the reference's properties, in the port
# ---------------------------------------------------------------------------

class TestRaggedContinuousBatching:
    def test_mixed_lengths_match_solo_runs(self, dense):
        cfg, params = dense
        prompts = _prompts(cfg, 3, 12, seed=3)
        lens = np.array([5, 12, 9], np.int32)
        mixed = serve.generate(cfg, params, prompts, max_new=6,
                               prompt_lens=lens)
        for i, n in enumerate(lens):
            solo = serve.generate(cfg, params, prompts[i:i + 1, :n], max_new=6)
            assert (mixed[i] == solo[0]).all(), (i, mixed[i], solo[0])

    def test_pad_contents_never_observed(self, dense):
        cfg, params = dense
        lens = np.array([4, 9, 7], np.int32)
        a = _prompts(cfg, 3, 9, seed=5)
        b = a.copy()
        for i, n in enumerate(lens):
            b[i, n:] = (b[i, n:] + 17) % cfg.vocab   # different junk
        out_a = serve.generate(cfg, params, a, max_new=5, prompt_lens=lens)
        out_b = serve.generate(cfg, params, b, max_new=5, prompt_lens=lens)
        assert (out_a == out_b).all()

    def test_full_lens_equals_uniform_path(self, dense):
        cfg, params = dense
        prompts = _prompts(cfg, 4, 8, seed=7)
        uniform = serve.generate(cfg, params, prompts, max_new=5)
        ragged = serve.generate(cfg, params, prompts, max_new=5,
                                prompt_lens=np.full((4,), 8, np.int32))
        assert (uniform == ragged).all()

    @pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m"])
    def test_ragged_refused_for_ring_and_recurrent_families(self, arch,
                                                            models):
        _, _, cfg, params = models(arch)
        with pytest.raises(NotImplementedError, match="ragged"):
            serve.generate(cfg, params, _prompts(cfg, 2, 10), max_new=2,
                           prompt_lens=np.array([6, 10], np.int32))


class TestCacheGrow:
    def test_grow_pads_end_and_casts(self, dense):
        cfg, params = dense
        b, s0, total = 2, 6, 14
        _, cache = step_lib.make_prefill_step(cfg)(
            params, {"tokens": torch.from_numpy(_prompts(cfg, b, s0))})
        target = transformer.abstract_cache(cfg, b, total)
        grown = serve.grow_cache(cache, target)
        for leaf, tgt in zip(tree_leaves(grown),
                             tree_leaves(target, transformer.is_tensor_spec)):
            assert tuple(leaf.shape) == tgt.shape and leaf.dtype == tgt.dtype
        assert torch.equal(grown["k"][:, :, :s0], cache["k"])
        assert not grown["k"][:, :, s0:].any()

    def test_grow_is_identity_at_target_shape(self, dense):
        cfg, _ = dense
        cache = transformer.init_cache(cfg, 2, 10, device="cpu")
        grown = serve.grow_cache(cache, transformer.abstract_cache(cfg, 2, 10))
        for a, g in zip(tree_leaves(cache), tree_leaves(grown)):
            assert torch.equal(a, g)

    def test_fit_shrinks_then_pads(self, dense):
        cfg, _ = dense
        cache = transformer.init_cache(cfg, 1, 10, device="cpu")
        cache = {k: torch.randn(v.shape).to(v.dtype) for k, v in cache.items()}
        for width in (4, 10, 16):
            fit = serve.fit_cache(cache, transformer.abstract_cache(cfg, 1,
                                                                    width))
            n = min(width, 10)
            assert fit["k"].shape[2] == width
            assert torch.equal(fit["k"][:, :, :n], cache["k"][:, :, :n])
            assert not fit["k"][:, :, n:].any()


class TestSampling:
    def test_fixed_seed_is_deterministic(self, dense):
        cfg, params = dense
        prompts = _prompts(cfg, 3, 8, seed=11)
        one = serve.generate(cfg, params, prompts, max_new=6,
                             temperature=0.8, seed=42)
        two = serve.generate(cfg, params, prompts, max_new=6,
                             temperature=0.8, seed=42)
        assert (one == two).all()

    def test_seed_changes_samples(self, dense):
        cfg, params = dense
        prompts = _prompts(cfg, 4, 8, seed=11)
        a = serve.generate(cfg, params, prompts, max_new=8, temperature=2.0,
                           seed=0)
        b = serve.generate(cfg, params, prompts, max_new=8, temperature=2.0,
                           seed=1)
        assert (a != b).any()
        assert ((a >= 0) & (a < cfg.vocab)).all()

    def test_slot_stream_sampling_is_deterministic(self, dense):
        cfg, params = dense
        prompts = _prompts(cfg, 3, 8, seed=31)
        one = serve.generate(cfg, params, prompts, max_new=5, temperature=0.8,
                             seed=42, stream="slots", slots=2)
        two = serve.generate(cfg, params, prompts, max_new=5, temperature=0.8,
                             seed=42, stream="slots", slots=2)
        assert (one == two).all()


class TestKVStorage:
    @pytest.mark.parametrize("arch", ["paper-lm-100m", "minicpm3-4b"])
    @pytest.mark.parametrize("storage,bar", [("int8", 0.05), ("f8", 0.08)])
    def test_quantized_storage_logits_match_bf16(self, arch, storage, bar):
        cfg = smoke_config(arch)
        params = transformer.init_params(cfg, seed=0, device="cpu")
        b, s0, total = 2, 8, 16
        prompts = torch.from_numpy(_prompts(cfg, b, s0, seed=13))
        logits0, cache = step_lib.make_prefill_step(cfg)(params,
                                                         {"tokens": prompts})
        cache = serve.grow_cache(cache, transformer.abstract_cache(cfg, b,
                                                                   total))
        tok = torch.argmax(logits0, -1).to(torch.int32)[:, None]
        batch = {"tokens": tok, "pos": torch.tensor(s0, dtype=torch.int32)}
        out = {}
        for st in ("bf16", storage):
            c = transformer.quantize_cache(cache, st)
            lg, new_c = step_lib.make_decode_step(cfg, total, "bf16", st)(
                params, c, batch)
            assert sorted(new_c) == sorted(c)
            assert all(new_c[k].dtype == c[k].dtype for k in c)
            out[st] = lg.float()
        scale = max(float(out["bf16"].abs().max()), 1.0)
        assert float((out["bf16"] - out[storage]).abs().max()) / scale < bar

    @pytest.mark.parametrize("storage", ["int8", "f8"])
    def test_quantized_generate_tracks_bf16_tokens(self, dense, storage):
        cfg, params = dense
        prompts = _prompts(cfg, 3, 10, seed=17)
        base = serve.generate(cfg, params, prompts, max_new=8)
        quant = serve.generate(cfg, params, prompts, max_new=8,
                               kv_storage=storage)
        assert (base == quant).all(axis=1).mean() >= 0.5, (base, quant)

    def test_cache_layouts(self):
        cfg = smoke_config("paper-lm-100m")
        i8 = transformer.abstract_cache(cfg, 2, 16, kv_storage="int8")
        assert i8["k"].dtype == torch.int8
        assert i8["k_scale"].dtype == torch.float32
        assert i8["k_scale"].shape[:-1] == i8["k"].shape[:-1]
        bf = transformer.abstract_cache(cfg, 2, 16)
        f8 = transformer.abstract_cache(cfg, 2, 16, kv_storage="f8")
        assert set(f8) == set(bf)                  # no _scale companions
        assert f8["k"].dtype == torch.float8_e4m3fn
        assert sum(l.nbytes for l in f8.values()) * 2 == \
            sum(l.nbytes for l in bf.values())
        # the layouts are the reference's, leaf for leaf
        rcfg = ref_smoke_config("paper-lm-100m")
        for st in ("bf16", "int8", "f8"):
            want = ref_tf.abstract_cache(rcfg, 2, 16, kv_storage=st)
            got = transformer.abstract_cache(cfg, 2, 16, kv_storage=st)
            assert {k: v.shape for k, v in got.items()} == \
                {k: tuple(v.shape) for k, v in want.items()}
            assert transformer.cache_axes(cfg, 2, 16, st) == \
                ref_tf.cache_axes(rcfg, 2, 16, st)


class TestSlotStreaming:
    def test_slot_stream_matches_batch_ragged(self, dense):
        cfg, params = dense
        prompts = _prompts(cfg, 3, 12, seed=3)
        lens = np.array([5, 12, 9], np.int32)
        batch = serve.generate(cfg, params, prompts, max_new=6,
                               prompt_lens=lens)
        slot = serve.generate(cfg, params, prompts, max_new=6,
                              prompt_lens=lens, stream="slots")
        assert (batch == slot).all(), (batch, slot)

    def test_slot_reuse_no_cross_request_bleed(self, dense):
        cfg, params = dense
        prompts = _prompts(cfg, 4, 10, seed=23)
        lens = np.array([4, 10, 7, 9], np.int32)
        batch = serve.generate(cfg, params, prompts, max_new=5,
                               prompt_lens=lens)
        for n_slots in (1, 2):
            slot = serve.generate(cfg, params, prompts, max_new=5,
                                  prompt_lens=lens, stream="slots",
                                  slots=n_slots)
            assert (batch == slot).all(), (n_slots, batch, slot)

    def test_quantized_pipeline_mostly_agrees(self, dense):
        cfg, params = dense
        prompts = _prompts(cfg, 3, 8, seed=29)
        batch = serve.generate(cfg, params, prompts, max_new=5)
        q = serve.generate(cfg, params, prompts, max_new=5, stream="slots",
                           cache_transfer="int8", kv_storage="f8")
        assert q.shape == batch.shape
        assert ((q >= 0) & (q < cfg.vocab)).all()
        assert (batch == q).all(axis=1).mean() >= 0.5

    def test_single_token_requests_all_served(self, dense):
        cfg, params = dense
        prompts = _prompts(cfg, 5, 8, seed=37)
        batch = serve.generate(cfg, params, prompts, max_new=1)
        slot = serve.generate(cfg, params, prompts, max_new=1,
                              stream="slots", slots=2)
        assert slot.shape == (5, 1) and (batch == slot).all()

    @pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m"])
    def test_ring_and_recurrent_slots(self, arch, models):
        """Uniform slot tokens equal the batch path, even through one
        reused slot; ragged slot tokens equal solo runs."""
        _, _, cfg, params = models(arch)
        prompts = _prompts(cfg, 3, 10, seed=41)
        batch = serve.generate(cfg, params, prompts, max_new=4)
        for n_slots in (0, 1):
            slot = serve.generate(cfg, params, prompts, max_new=4,
                                  stream="slots", slots=n_slots)
            assert (batch == slot).all(), (n_slots, batch, slot)
        lens = np.array([6, 10, 8], np.int32)
        slot = serve.generate(cfg, params, prompts, max_new=4,
                              prompt_lens=lens, stream="slots", slots=2)
        for i, ln in enumerate(lens):
            solo = serve.generate(cfg, params, prompts[i:i + 1, :ln],
                                  max_new=4)
            assert (slot[i] == solo[0]).all(), (i, slot[i], solo[0])

    def test_unknown_stream_refused(self, dense):
        cfg, params = dense
        with pytest.raises(ValueError, match="stream"):
            serve.generate(cfg, params, _prompts(cfg, 2, 8), max_new=2,
                           stream="rows")


class TestStateStoreBleed:
    @pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m"])
    def test_readmission_leaves_no_trace_of_previous_occupant(self, arch,
                                                              models):
        _, _, cfg, params = models(arch)
        store = registry.state_store(cfg, rows=2, total=16)
        prefill = step_lib.make_prefill_step(cfg)

        def row_state(seed):
            _, c = prefill(params, {"tokens": torch.from_numpy(
                _prompts(cfg, 1, 8, seed=seed))})
            return serve.grow_cache(c, store.abstract_row())

        def equal(x, y):
            return all(torch.equal(a, b)
                       for a, b in zip(tree_leaves(x), tree_leaves(y)))

        row_a, row_b = row_state(51), row_state(52)
        fresh_b = store.admit_row(store.init_state("cpu"), row_b, 0)
        state = store.admit_row(store.init_state("cpu"), row_a, 0)
        assert not equal(state, fresh_b)
        assert equal(store.admit_row(state, row_b, 0), fresh_b)
        freed = store.free_row(state, 0)
        assert equal(freed, store.init_state("cpu"))
        assert equal(store.admit_row(freed, row_b, 0), fresh_b)


# ---------------------------------------------------------------------------
# the fan-in engine, single device
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fanin_setup():
    cfg = smoke_config("paper-lm-100m")
    params = transformer.init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab, size=(4, 12)).astype(np.int32)
    lens = np.array([7, 12, 9, 11], np.int32)
    golden = serve.generate(cfg, params, prompts, max_new=8,
                            prompt_lens=lens)
    return cfg, params, prompts, lens, golden


class TestFanInEngine:
    def test_uncontended_fanin_matches_batch_path(self, fanin_setup):
        cfg, params, prompts, lens, golden = fanin_setup
        out = serve.generate(cfg, params, prompts, max_new=8,
                             prompt_lens=lens, workers=2)
        assert (out == golden).all(), (out, golden)
        st = serve._generate_fanin.last_stats
        assert st["admissions"] == 4 and st["evictions"] == 0

    def test_replay_is_deterministic(self, fanin_setup):
        cfg, params, prompts, lens, _ = fanin_setup
        kw = dict(max_new=8, prompt_lens=lens, workers=2, slots=2,
                  evict="oldest")
        a = serve.generate(cfg, params, prompts, **kw)
        sa = dict(serve._generate_fanin.last_stats)
        b = serve.generate(cfg, params, prompts, **kw)
        sb = dict(serve._generate_fanin.last_stats)
        sa.pop("transfer_wait_s")
        sb.pop("transfer_wait_s")
        assert (a == b).all() and sa == sb

    @pytest.mark.parametrize("workers,evict", [(3, "oldest"),
                                               (2, "priority")])
    def test_contention_and_workers_keep_tokens(self, fanin_setup, workers,
                                                evict):
        cfg, params, prompts, lens, golden = fanin_setup
        prios = np.array([1, 1, 0, 0], np.int32) if evict == "priority" \
            else None
        slots = 2 if evict == "priority" else 0
        out = serve.generate(cfg, params, prompts, max_new=8,
                             prompt_lens=lens, workers=workers, slots=slots,
                             evict=evict, priorities=prios)
        assert (out == golden).all(), (out, golden)
        if evict == "priority":
            st = serve._generate_fanin.last_stats
            assert st["evictions"] > 0 and st["requeues"] > 0

    def test_promotion_driven_oldest_eviction_matches(self, fanin_setup):
        cfg, params, prompts, lens, golden = fanin_setup
        out = serve.generate(cfg, params, prompts, max_new=8,
                             prompt_lens=lens, workers=2, slots=2,
                             evict="oldest")
        assert (out == golden).all(), (out, golden)

    def test_sampling_is_refused(self, fanin_setup):
        cfg, params, prompts, lens, _ = fanin_setup
        with pytest.raises(ValueError, match="greedy"):
            serve.generate(cfg, params, prompts, max_new=8,
                           prompt_lens=lens, workers=2, temperature=0.7)


class TestPagedEngine:
    @pytest.mark.parametrize("page_size", [0, 8])
    def test_paged_matches_unpaged(self, fanin_setup, page_size):
        cfg, params, prompts, lens, golden = fanin_setup
        out = serve.generate(cfg, params, prompts, max_new=8,
                             prompt_lens=lens, workers=2, paged=True,
                             page_size=page_size)
        assert (out == golden).all(), (out, golden)
        st = serve._generate_fanin.last_stats
        assert st["page"] >= 1 and st["peak_live_pages"] >= 1
        assert st["hbm_bytes_per_slot"] < st["dense_hbm_bytes_per_slot"]

    def test_paged_eviction_quantized_storage_matches(self, fanin_setup):
        """Pages + preemption + int8-resident storage: the paged contended
        run equals the unpaged uncontended fan-in under the same storage
        arm (the property the reference's test states). It holds on the
        port's weights here, not by construction: a readmission's first
        token comes from prefill logits over exact K/V, so under lossy
        storage a close margin can flip it (the reference's own run flips
        one, ``test_torch_serve_layers.py::
        test_recompute_preemption_under_int8_storage_is_not_exact``)."""
        cfg, params, prompts, lens, _ = fanin_setup
        base = serve.generate(cfg, params, prompts, max_new=8,
                              prompt_lens=lens, workers=2, kv_storage="int8")
        out = serve.generate(cfg, params, prompts, max_new=8,
                             prompt_lens=lens, workers=2, slots=2,
                             evict="priority", paged=True, page_size=8,
                             kv_storage="int8",
                             priorities=np.array([1, 1, 0, 0], np.int32))
        assert (out == base).all(), (out, base)
        assert serve._generate_fanin.last_stats["evictions"] > 0

    def test_long_request_refused_unpaged_admitted_paged(self, fanin_setup):
        cfg, params, prompts, lens, golden = fanin_setup
        with pytest.raises(ValueError, match="refusing to truncate"):
            serve.generate(cfg, params, prompts, max_new=8,
                           prompt_lens=lens, workers=2, horizon=12)
        out = serve.generate(cfg, params, prompts, max_new=8,
                             prompt_lens=lens, workers=2, horizon=12,
                             paged=True, page_size=8)
        assert (out == golden).all(), (out, golden)

    def test_batch_path_refuses_silent_truncation_too(self, fanin_setup):
        cfg, params, prompts, lens, _ = fanin_setup
        with pytest.raises(ValueError, match="refusing"):
            serve.generate(cfg, params, prompts, max_new=8,
                           prompt_lens=lens, horizon=12)
        with pytest.raises(ValueError, match="prompt buffer"):
            serve.generate(cfg, params, prompts, max_new=8,
                           prompt_lens=lens + 1)

    def test_pool_limits_are_loud(self, fanin_setup):
        cfg, params, prompts, lens, _ = fanin_setup
        with pytest.raises(RuntimeError, match="paged pool exhausted"):
            serve.generate(cfg, params, prompts, max_new=8,
                           prompt_lens=lens, workers=2, paged=True,
                           page_size=4, pool_pages=6)
        with pytest.raises(ValueError, match="pool of 1 pages"):
            serve.generate(cfg, params, prompts, max_new=8,
                           prompt_lens=lens, workers=2, paged=True,
                           page_size=4, pool_pages=1)


def test_fanin_module_is_the_reference_copy():
    """``dist/fanin.py`` is the reference's, byte for byte (it imports
    nothing of either package)."""
    want = (ROOT / "src/repro/dist/fanin.py").read_text()
    got = (ROOT / "src/repro_torch/dist/fanin.py").read_text()
    assert got == want


# ---------------------------------------------------------------------------
# refusals, the launcher, the shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(decode_mesh="local"),
                                dict(decode_rules="serve_decode"),
                                dict(prefill_meshes="two")])
def test_multi_device_arguments_wait_for_item_3(dense, kw):
    """The multi-device arguments behave as the reference's in one
    process: a decode mesh needs a prefill mesh, decode rules alone leave
    one device's tokens as they are, and fan-in needs one prefill mesh per
    worker. (Serving across ranks: ``test_torch_serve_ranks.py``.)"""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh
    cfg, params = dense
    prompts = _prompts(cfg, 2, 8)
    local = make_local_mesh(device="cpu")
    if "decode_mesh" in kw:
        with pytest.raises(ValueError, match="needs a prefill mesh too"):
            serve.generate(cfg, params, prompts, max_new=2,
                           decode_mesh=local)
    elif "decode_rules" in kw:
        out = serve.generate(cfg, params, prompts, max_new=2,
                             decode_rules=shd.PRESETS["serve_decode"])
        assert (out == serve.generate(cfg, params, prompts,
                                      max_new=2)).all()
    else:
        with pytest.raises(ValueError, match="one mesh per worker"):
            serve.generate(cfg, params, prompts, max_new=2,
                           prefill_meshes=[local, local])


@pytest.mark.parametrize("fn", ["make_cache_mover", "make_disagg_meshes",
                                "make_fanin_meshes", "disagg_decode_report",
                                "fanin_report"])
def test_multi_device_functions_wait_for_item_3(fn, dense):
    """Each multi-device function in one process, where the reference
    degrades to (1, 1) meshes: the movers are the identity (bf16) and the
    one-device round trip (int8), the meshes are the one-process mesh, the
    disaggregated report moves no byte, the fan-in report is the
    reference's."""
    from repro_torch.launch.mesh import make_local_mesh
    cfg, params = dense
    if fn == "make_cache_mover":
        _, cache = step_lib.make_prefill_step(cfg)(
            params, {"tokens": torch.from_numpy(_prompts(cfg, 2, 8))})
        bf16 = serve.make_cache_mover(cfg, 2, 8, make_local_mesh(
            device="cpu"), None, "bf16", None)(cache)
        assert all(a is b for a, b in zip(tree_leaves(bf16),
                                           tree_leaves(cache)))
        int8 = serve.make_cache_mover(cfg, 2, 8, None, None, "int8",
                                      None)(cache)
        want = serve.make_cache_transfer_step(cfg, 2, 8, "int8")(cache)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(int8),
                                                      tree_leaves(want)))
    elif fn == "make_disagg_meshes":
        pre, dec = serve.make_disagg_meshes(cfg, device="cpu")
        assert pre.shape == dec.shape == {"data": 1, "model": 1}
    elif fn == "make_fanin_meshes":
        pres, dec = serve.make_fanin_meshes(cfg, 3, device="cpu")
        assert len(pres) == 3 and dec.shape == {"data": 1, "model": 1}
        with pytest.raises(ValueError, match="at least one prefill worker"):
            serve.make_fanin_meshes(cfg, 0, device="cpu")
    elif fn == "disagg_decode_report":
        rep = serve.disagg_decode_report(
            cfg, 2, 16, make_local_mesh(device="cpu"), ici_bw=1e9,
            hbm_bw=1e12, params=params)
        assert set(rep["cells"]) == {f"{t}x{s}" for t in ("bf16", "int8")
                                     for s in ("bf16", "int8", "f8")}
        assert all(c["transfer_wire_bytes_bf16eq"] == 0
                   for c in rep["cells"].values())
    else:
        rcfg = ref_smoke_config("granite-3-8b")
        kw = dict(workers=2, slots=3, classes=2, evict="priority",
                  max_new=6, decode_step_s=0.01, transfer_s=0.05)
        assert serve.fanin_report(cfg, 8, 48, **kw) == \
            ref_serve.fanin_report(rcfg, 8, 48, **kw)


def test_a_larger_mesh_waits_but_a_local_one_serves(dense):
    """A one-process mesh of two devices is refused (more than one device
    is a ``DeviceMesh`` over ranks); the one-device mesh serves."""
    from repro_torch.launch.mesh import LocalMesh, make_local_mesh
    cfg, params = dense
    prompts = _prompts(cfg, 2, 8)
    two = LocalMesh(("data", "model"),
                    np.array([[torch.device("cpu")] * 2], dtype=object))
    with pytest.raises(ValueError, match="one-process mesh of 2 devices"):
        serve.generate(cfg, params, prompts, max_new=2, mesh=two)
    out = serve.generate(cfg, params, prompts, max_new=2,
                         mesh=make_local_mesh(device="cpu"))
    assert (out == serve.generate(cfg, params, prompts, max_new=2)).all()


def test_cache_transfer_step_rounds_only_sequence_leaves(models):
    _, _, cfg, params = models("hymba-1.5b")
    _, cache = step_lib.make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(_prompts(cfg, 2, 8))})
    assert serve.make_cache_transfer_step(cfg, 2, 8, "bf16")(cache)["k"] \
        is cache["k"]
    moved = serve.make_cache_transfer_step(cfg, 2, 8, "int8")(cache)
    assert not torch.equal(moved["k"], cache["k"])
    assert torch.equal(moved["ssm_ssm"], cache["ssm_ssm"])
    with pytest.raises(ValueError, match="cache_transfer"):
        serve.make_cache_transfer_step(cfg, 2, 8, "f8")


def test_main_serves_on_the_host(capsys):
    serve.main(["--arch", "granite-3-8b", "--batch", "3", "--prompt-len",
                "8", "--max-new", "3", "--workers", "2", "--paged",
                "--slots", "2", "--priority-classes", "2", "--evict",
                "priority", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] arch=granite-3-8b-smoke" in out
    assert "mesh={'data': 1, 'model': 1}" in out
    assert "[serve] fan-in: workers=2" in out and "[serve] paged: page=" in out


def test_main_defaults_to_the_card_and_refuses_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--max-new", "1"])
    # one process: --disagg serves on the one-process pair of meshes, as
    # the reference's on one device; --tp 2 needs a process group
    serve.main(["--disagg", "--max-new", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="needs a process group"):
        serve.main(["--tp", "2", "--device", "cpu"])


def test_parser_matches_the_reference():
    want = ref_serve.build_parser()
    got = serve.build_parser()
    w = {a.dest: (a.default, a.choices) for a in want._actions}
    g = {a.dest: (a.default, a.choices) for a in got._actions}
    assert g.pop("device") == ("cuda", None)
    w["preset"] = (w["preset"][0], tuple(w["preset"][1]))
    assert g == w
    args = serve.build_parser().parse_args(["--arch", "granite-3-8b",
                                            "--full"])
    assert serve.resolve_config(args) == get_config("granite-3-8b")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert shapes.SHAPE_IDS == ref_shapes.SHAPE_IDS
    assert shapes.expand_shape_names("prefill_8k,decode") == \
        ref_shapes.expand_shape_names("prefill_8k,decode")
    for name in shapes.SHAPE_IDS:
        sh, rsh = shapes.SHAPES[name], ref_shapes.SHAPES[name]
        assert dataclasses.asdict(sh) == dataclasses.asdict(rsh)
        assert shapes.applicable(cfg, sh) == ref_shapes.applicable(rcfg, rsh)
        if not shapes.applicable(cfg, sh)[0]:
            continue
        assert shapes.batch_axes(cfg, sh) == ref_shapes.batch_axes(rcfg, rsh)
        batch, cache = shapes.input_specs(cfg, sh)
        rbatch, rcache = ref_shapes.input_specs(rcfg, rsh)
        assert {k: v.shape for k, v in batch.items()} == \
            {k: tuple(v.shape) for k, v in rbatch.items()}
        if cache is not None:
            assert [l.shape for l in tree_leaves(
                cache, transformer.is_tensor_spec)] == \
                [tuple(l.shape) for l in jax.tree.leaves(rcache)]
        if sh.kind != "train":
            assert step_lib.step_for_shape(cfg, sh)[1] == \
                ref_step.step_for_shape(rcfg, rsh)[1]


def test_make_batch_is_seeded_and_in_range():
    cfg = smoke_config("granite-3-8b")
    sh = dataclasses.replace(shapes.SHAPES["decode_32k"], seq_len=16,
                             global_batch=3)
    a, ca = shapes.make_batch(cfg, sh, torch.Generator().manual_seed(5),
                              device="cpu")
    b, _ = shapes.make_batch(cfg, sh, torch.Generator().manual_seed(5),
                             device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (3, 1) and int(a["pos"]) == 15
    assert ((a["tokens"] >= 0) & (a["tokens"] < cfg.vocab)).all()
    assert ca["k"].shape == (cfg.n_layers, 3, 16, cfg.n_kv_heads,
                             cfg.head_dim) and not ca["k"].any()
    tr, _ = shapes.make_batch(smoke_config("hubert-xlarge"),
                              dataclasses.replace(shapes.SHAPES["train_4k"],
                                                  seq_len=8, global_batch=2),
                              torch.Generator().manual_seed(1), device="cpu")
    assert tr["mask"].dtype == torch.bool and tr["frames"].dtype == \
        torch.bfloat16
