"""The port's compact_pack op against the JAX package's, on the CPU.

The planners (numpy in both packages) must produce element-equal tables,
and the port's ``compact_chunks`` on CPU tensors -- the kernels' plain
PyTorch versions, driven by the same plan tables the CUDA kernels read --
must be bit-equal (tolerance 0) to the JAX ``compact_chunks``, which runs
its Pallas kernels in interpret mode here. The grid is the fused-filter
grid of tests/test_kernel_registry.py (plans x keep fractions 0, 0.3, 1.0)
across every ``block_chunks`` candidate, with and without ``keep_mask``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.compact_pack import ops as jops
from repro_torch.kernels.compact_pack import compact_pack as tkern
from repro_torch.kernels.compact_pack import ops as tops

PLANS = [
    ([4, 4, 4, 4], [3, 1, 2, 0]),
    ([2, 6, 8], None),
    ([3, 1, 2], [2, 0, 1]),
]
PLAN_IDS = ["reversed", "in-order", "non-aligned"]
FRACS = [0.0, 0.3, 1.0]
BLOCKS = [1, 2, 4, 8, 16]
CHUNK_TOKENS = tkern.CHUNK_TOKENS
CHUNK_ROWS = tkern.CHUNK_ROWS


def _inputs(plan, frac):
    counts, order = plan
    rng = np.random.RandomState(
        1000 * PLANS.index(plan) + int(round(10 * frac)))
    src = rng.randint(0, 1 << 30, sum(counts) * CHUNK_TOKENS,
                      np.int64).astype(np.int32)
    cm = jops.plan_compaction(counts, fragment_order=order)
    keep = rng.rand(len(cm) * CHUNK_ROWS) >= frac
    return src, cm, keep


@functools.lru_cache(maxsize=None)
def _jax_out(plan_i, frac, filtered, block_chunks):
    src, cm, keep = _inputs(PLANS[plan_i], frac)
    out = jops.compact_chunks(jnp.asarray(src), cm,
                              keep_mask=keep if filtered else None,
                              block_chunks=block_chunks)
    return np.asarray(out)


class TestPlanTables:
    @pytest.mark.parametrize("plan", PLANS, ids=PLAN_IDS)
    def test_plan_compaction_matches(self, plan):
        counts, order = plan
        a = tops.plan_compaction(counts, fragment_order=order)
        b = jops.plan_compaction(counts, fragment_order=order)
        assert a.dtype == b.dtype and np.array_equal(a, b)

    @pytest.mark.parametrize("plan", PLANS + [([16, 16], None)],
                             ids=PLAN_IDS + ["aligned-runs"])
    @pytest.mark.parametrize("block_chunks", BLOCKS)
    def test_coarsen_plan_matches(self, plan, block_chunks):
        counts, order = plan
        cm = jops.plan_compaction(counts, fragment_order=order)
        ga, a = tops.coarsen_plan(cm, sum(counts), block_chunks)
        gb, b = jops.coarsen_plan(cm, sum(counts), block_chunks)
        assert ga == gb and a.dtype == b.dtype and np.array_equal(a, b)

    @pytest.mark.parametrize("plan", PLANS, ids=PLAN_IDS)
    @pytest.mark.parametrize("frac", FRACS + [0.9])
    def test_plan_filter_matches(self, plan, frac):
        _, cm, keep = _inputs(plan, frac)
        a = tops.plan_filter(cm, keep)
        b = jops.plan_filter(cm, keep)
        assert a[4] == b[4]
        for x, y in zip(a[:4], b[:4]):
            assert x.dtype == y.dtype and np.array_equal(x, y)

    def test_plan_filter_flush_step_matches(self):
        """Two chunks keep 5 rows each: the last step completes chunk 0
        and spills 2 rows, so both planners append the same flush step."""
        cm = np.arange(2, dtype=np.int32)
        keep = np.tile([True] * 5 + [False] * 3, 2)
        a = tops.plan_filter(cm, keep)
        b = jops.plan_filter(cm, keep)
        assert a[0].shape[0] == 3          # 2 touched steps + the flush
        for x, y in zip(a[:4], b[:4]):
            assert np.array_equal(x, y)


class TestCompactChunksBitMatch:
    @pytest.mark.parametrize("plan_i", range(len(PLANS)), ids=PLAN_IDS)
    @pytest.mark.parametrize("block_chunks", BLOCKS)
    def test_gather_matches_jax(self, plan_i, block_chunks):
        src, cm, _ = _inputs(PLANS[plan_i], 0.0)
        out = tops.compact_chunks(torch.from_numpy(src), cm,
                                  block_chunks=block_chunks)
        want = _jax_out(plan_i, 0.0, False, block_chunks)
        assert out.dtype == torch.int32
        assert np.array_equal(out.numpy(), want)

    @pytest.mark.parametrize("plan_i", range(len(PLANS)), ids=PLAN_IDS)
    @pytest.mark.parametrize("frac", FRACS)
    @pytest.mark.parametrize("block_chunks", BLOCKS)
    def test_fused_filter_matches_jax(self, plan_i, frac, block_chunks):
        src, cm, keep = _inputs(PLANS[plan_i], frac)
        out = tops.compact_chunks(torch.from_numpy(src), cm, keep_mask=keep,
                                  block_chunks=block_chunks)
        # the JAX fused kernel ignores block_chunks: one run per cell
        want = _jax_out(plan_i, frac, True, 1)
        assert np.array_equal(out.numpy(), want)
        assert out.shape[0] == -(-int(keep.sum()) // CHUNK_ROWS) * CHUNK_TOKENS

    @pytest.mark.parametrize("plan_i", range(len(PLANS)), ids=PLAN_IDS)
    @pytest.mark.parametrize("frac", FRACS)
    def test_two_pass_plain_version_matches_jax(self, plan_i, frac):
        src, cm, keep = _inputs(PLANS[plan_i], frac)
        out = tops.compact_chunks(torch.from_numpy(src), cm, keep_mask=keep,
                                  use_ref=True)
        assert np.array_equal(out.numpy(), _jax_out(plan_i, frac, True, 1))

    def test_flush_step_output_matches_jax(self):
        src = np.arange(2 * CHUNK_TOKENS, dtype=np.int32) + 1
        cm = np.arange(2, dtype=np.int32)
        keep = np.tile([True] * 5 + [False] * 3, 2)
        out = tops.compact_chunks(torch.from_numpy(src), cm, keep_mask=keep)
        want = np.asarray(jops.compact_chunks(jnp.asarray(src), cm,
                                              keep_mask=keep))
        assert np.array_equal(out.numpy(), want)
        assert out.shape[0] == 2 * CHUNK_TOKENS
        assert out[10 * 128 - 1] != 0
        assert not out[10 * 128:].any()        # the zero-padded tail

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_float_filter_copies_bits_like_jax_ref(self, dtype):
        """Float payloads with -0.0: the port copies bits, as the JAX
        two-pass reference does (the JAX Pallas kernel sums rows into a
        zero window and so would turn -0.0 into +0.0)."""
        rng = np.random.RandomState(7)
        vals = rng.standard_normal(6 * CHUNK_TOKENS).astype(np.float32)
        vals[::5] = -0.0
        cm = jops.plan_compaction([2, 4], fragment_order=[1, 0])
        keep = rng.rand(len(cm) * CHUNK_ROWS) >= 0.3
        tdt = getattr(torch, dtype)
        src_t = torch.from_numpy(vals).to(tdt)
        src_j = jnp.asarray(vals).astype(getattr(jnp, dtype))
        ints = torch.int32 if dtype == "float32" else torch.int16
        for mask in (None, keep):
            got = tops.compact_chunks(src_t, cm, keep_mask=mask)
            want = np.asarray(jops.compact_chunks(src_j, cm, keep_mask=mask,
                                                  use_ref=True))
            want_t = torch.from_numpy(
                want.view(np.int32 if dtype == "float32" else np.int16).copy())
            assert torch.equal(got.view(ints), want_t)

    def test_empty_plan_and_drop_all_return_empty(self):
        src = torch.arange(2 * CHUNK_TOKENS, dtype=torch.int32)
        assert tops.compact_chunks(src, np.zeros(0, np.int32)).shape == (0,)
        cm = np.arange(2, dtype=np.int32)
        out = tops.compact_chunks(src, cm, keep_mask=np.zeros(16, bool))
        assert out.shape == (0,) and out.dtype == torch.int32


class TestWrapperContract:
    def test_cpu_tensors_run_plain_versions_without_counting(self):
        tkern.reset_launches()
        src, cm, keep = _inputs(PLANS[0], 0.3)
        tops.compact_chunks(torch.from_numpy(src), cm)
        tops.compact_chunks(torch.from_numpy(src), cm, keep_mask=keep)
        assert tkern.LAUNCHES == {"compact_chunks": 0, "compact_filter": 0}

    def test_tables_ref_places_rows_like_two_pass(self):
        """The plain version the CPU runs reads plan_filter's tables the
        way the CUDA kernel does: row j of step i lands at output row
        8*out_idx[i] + dest[8i+j]."""
        src, cm, keep = _inputs(PLANS[2], 0.3)
        src3 = torch.from_numpy(src).reshape(-1, CHUNK_ROWS, 128)
        chunk_sel, dest, _, out_idx, n_out = tops.plan_filter(cm, keep)
        got = tkern.compact_filter_kernel(
            src3, torch.from_numpy(chunk_sel), torch.from_numpy(dest),
            torch.from_numpy(out_idx), n_out, int(keep.sum()))
        from repro_torch.kernels.compact_pack.ref import compact_filter_ref
        want = compact_filter_ref(src3, torch.from_numpy(cm), keep)
        assert torch.equal(got, want)
