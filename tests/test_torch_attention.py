"""The port's attention ops (decode_attn, paged_attn, flash_attn) against
the JAX package's, on the CPU.

The same numpy inputs (made from a seed, cast to bf16 the same way in both
packages) go through the JAX ``api.call``, which runs the Pallas kernels in
interpret mode here, and the port's ``api.call`` on CPU tensors, which runs
the kernels' plain PyTorch versions; they agree within the op's ``tol``
(5e-2 absolute for bf16 outputs of unit-normal inputs). The plain versions
of both packages agree within 1e-5 in float32. The grid covers GQA groups
1/2/4, windows 32/128, non-causal attention, and ragged decode lengths with
a ``lengths == 0`` row, where both packages average v over every position.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import api as japi
from repro.kernels import tuned as jtuned
from repro.kernels.decode_attn.ref import decode_attention_ref as jdecode_ref
from repro.kernels.flash_attn.ref import flash_attention_ref as jflash_ref
from repro.kernels.paged_attn import ref as jpaged
from repro.kernels.paged_attn import tuned_page_size as jtuned_page_size
from repro_torch.kernels import api, tuned
from repro_torch.kernels.decode_attn import decode_attention
from repro_torch.kernels.decode_attn import decode_attn as tdecode
from repro_torch.kernels.decode_attn.ref import decode_attention_ref
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.flash_attn.ref import flash_attention_ref
from repro_torch.kernels.paged_attn import (gather_pages, pack_pages,
                                            paged_attention,
                                            paged_attention_ref,
                                            tuned_page_size)

GROUPS = [1, 2, 4]
MASKS = [(True, 0), (True, 32), (True, 128), (False, 0), (False, 32)]
MASK_IDS = ["causal", "causal-w32", "causal-w128", "full", "full-w32"]


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16), \
        torch.from_numpy(a).to(torch.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _decode_inputs(group, seed, b=4, s=256, hkv=2, d=64):
    rng = np.random.RandomState(seed)
    q = _randn(rng, b, hkv * group, d)
    k = _randn(rng, b, s, hkv, d)
    v = _randn(rng, b, s, hkv, d)
    lens = np.array([0, s, 100, 37][:b], np.int32)
    return q, k, v, lens


def _flash_inputs(group, seed, b=1, s=256, hkv=2, d=64):
    rng = np.random.RandomState(seed)
    return (_randn(rng, b, hkv * group, s, d), _randn(rng, b, hkv, s, d),
            _randn(rng, b, hkv, s, d))


@pytest.fixture()
def tuned_dirs(tmp_path, monkeypatch):
    """Both packages' tuned-point caches in throwaway dirs."""
    monkeypatch.setenv("REPRO_TUNED_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("REPRO_TORCH_TUNED_DIR", str(tmp_path / "torch"))
    jtuned.invalidate_memo()
    tuned.invalidate_memo()
    yield
    jtuned.invalidate_memo()
    tuned.invalidate_memo()


class TestDecode:
    @pytest.mark.parametrize("group", GROUPS)
    @pytest.mark.parametrize("block_k", [64, 128])
    def test_call_matches_jax_kernel(self, group, block_k):
        q, k, v, lens = _decode_inputs(group, group)
        (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
        point = {"block_k": block_k}
        want = japi.call("decode_attn", jq, jk, jv, jnp.asarray(lens),
                         point=point)
        got = api.call("decode_attn", tq, tk, tv, torch.from_numpy(lens),
                       point=point)
        assert got.dtype == torch.bfloat16 and got.shape == tq.shape
        assert np.abs(_np(got) - _np(want)).max() \
            <= api.get_op("decode_attn").tol

    @pytest.mark.parametrize("group", GROUPS)
    def test_ref_matches_jax_ref_f32(self, group):
        q, k, v, lens = _decode_inputs(group, 10 + group, d=128)
        got = decode_attention_ref(*map(torch.from_numpy, (q, k, v, lens)))
        want = jdecode_ref(*map(jnp.asarray, (q, k, v, lens)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)

    def test_zero_length_row_is_the_mean_of_v(self):
        q, k, v, lens = _decode_inputs(2, 3)
        out = decode_attention(*map(torch.from_numpy, (q, k, v, lens)))
        mean_v = np.repeat(v[0].mean(axis=0), 2, axis=0)   # (H, D)
        np.testing.assert_allclose(out[0].numpy(), mean_v, atol=1e-5)
        want = jdecode_ref(*map(jnp.asarray, (q, k, v, lens)))
        np.testing.assert_allclose(out[0].numpy(), np.asarray(want)[0],
                                   atol=1e-5)

    @pytest.mark.parametrize("lens,hkv,s,block_k,n_sms,want", [
        # full width: 192 pieces over 132 CTAs, at most 5 in a row
        ([2733, 32768, 9846, 19649, 13124, 21244, 30404, 32104], 8, 32768,
         512, 132, (192, 5, 64, 132)),
        # fewer tiles than CTAs: one tile a CTA, one piece a row
        ([512, 256, 0, 100], 2, 512, 512, 132, (8, 1, 1, 8)),
        # every tile its own CTA; a length <= 0 row walks all S
        ([2048, 1024, -1, 37], 2, 2048, 128, 132, (82, 16, 16, 82)),
        # ragged last tile, two CTAs
        ([1000], 1, 1000, 128, 2, (2, 2, 2, 2)),
        # one long row at B 1 spreads over every CTA
        ([32768], 1, 32768, 128, 132, (132, 132, 132, 132)),
    ])
    def test_split_plan_covers_the_cache(self, lens, hkv, s, block_k, n_sms,
                                         want):
        """(pieces, most pieces in a row, the partials' bound, busy
        CTAs); every live position of every row in exactly one piece."""
        plan = tdecode.work_plan(lens, hkv, s, block_k, n_sms)
        per_row = {}
        for p in plan:
            per_row.setdefault((p.b, p.kvh), []).append((p.lo, p.hi))
        bound = tdecode.max_pieces(s, block_k, n_sms)
        assert (len(plan), max(map(len, per_row.values())), bound,
                len({p.cta for p in plan})) == want
        for (b, _), spans in per_row.items():
            live = min(lens[b], s) if lens[b] > 0 else s
            assert sorted(spans)[0][0] == 0 and sorted(spans)[-1][1] == live
            assert sum(hi - lo for lo, hi in spans) == live


class TestPaged:
    @pytest.mark.parametrize("page", [64, 128, 256])
    def test_pack_and_gather_bit_equal_to_jax(self, page):
        rng = np.random.RandomState(page)
        x = _randn(rng, 2, 512, 2, 8)
        jpool, jpt = jpaged.pack_pages(jnp.asarray(x), page)
        pool, pt = pack_pages(torch.from_numpy(x), page)
        assert np.array_equal(pool.numpy(), np.asarray(jpool))
        assert np.array_equal(pt.numpy(), np.asarray(jpt))
        assert pt.dtype == torch.int32
        table = pt.clone()
        table[0, -1] = -1                     # an unallocated page
        got = gather_pages(pool, table)
        want = jpaged.gather_pages(jpool, jnp.asarray(table.numpy()))
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(gather_pages(pool, pt).numpy(), x)

    def test_pack_rejects_a_page_that_does_not_divide(self):
        with pytest.raises(ValueError):
            pack_pages(torch.zeros(1, 100, 2), 64)

    @pytest.mark.parametrize("page", [64, 256])
    def test_call_matches_jax_and_decode(self, page):
        q, k, v, lens = _decode_inputs(4, 20 + page)
        (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
        want = japi.call("paged_attn", jq, jk, jv, jnp.asarray(lens),
                         point={"page": page})
        tl = torch.from_numpy(lens)
        got = paged_attention(tq, tk, tv, tl, page=page)
        assert np.abs(_np(got) - _np(want)).max() \
            <= api.get_op("paged_attn").tol
        assert torch.equal(got, decode_attention(tq, tk, tv, tl))
        assert torch.equal(paged_attention_ref(tq, tk, tv, tl, page),
                           decode_attention_ref(tq, tk, tv, tl))

    def test_tuned_page_size_matches_jax(self, tuned_dirs):
        assert tuned_page_size(2048, batch=4) \
            == jtuned_page_size(2048, batch=4) == 256
        assert tuned_page_size(300) == jtuned_page_size(300) == 4
        jop, op = japi.get_op("paged_attn"), api.get_op("paged_attn")
        jkey = jop.shape_key(*jop.example(False)[0])
        key = op.shape_key(*op.example(False, device="cpu")[0])
        assert key == jkey == "b4h8kv2s2048d64:bfloat16"
        jtuned.store("paged_attn", jkey, {"page": 64}, objective_us=1.0,
                     evaluations=4)
        tuned.store("paged_attn", key, {"page": 64}, objective_us=1.0,
                    evaluations=4)
        assert tuned_page_size(2048, batch=4) \
            == jtuned_page_size(2048, batch=4) == 64
        assert tuned_page_size(2048) == jtuned_page_size(2048) == 256


class TestFlash:
    @pytest.mark.parametrize("group", GROUPS)
    @pytest.mark.parametrize("causal,window", MASKS, ids=MASK_IDS)
    def test_call_matches_jax_kernel(self, group, causal, window):
        q, k, v = _flash_inputs(group, group * 7 + window)
        (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
        point = {"block_q": 128, "block_k": 128}
        want = japi.call("flash_attn", jq, jk, jv, causal=causal,
                         window=window, point=point)
        got = api.call("flash_attn", tq, tk, tv, causal=causal,
                       window=window, point=point)
        assert got.dtype == torch.bfloat16 and got.shape == tq.shape
        assert np.abs(_np(got) - _np(want)).max() \
            <= api.get_op("flash_attn").tol

    @pytest.mark.parametrize("causal,window", MASKS, ids=MASK_IDS)
    def test_ref_matches_jax_ref_f32(self, causal, window):
        q, k, v = _flash_inputs(2, 50 + window, s=192, d=128)
        got = flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, window=window)
        want = jflash_ref(*map(jnp.asarray, (q, k, v)), causal=causal,
                          window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)

    def test_public_wrapper_fills_the_other_block(self):
        q, k, v = map(torch.from_numpy, _flash_inputs(1, 5, s=128))
        out = flash_attention(q, k, v, block_q=128)
        assert torch.equal(out, flash_attention_ref(q, k, v))


class TestRegistryEntries:
    @pytest.mark.parametrize("name", ["decode_attn", "paged_attn",
                                      "flash_attn"])
    def test_tol_exact_axes_and_axis_names_match_jax(self, name):
        op, jop = api.get_op(name), japi.get_op(name)
        assert op.tol == jop.tol
        assert op.exact_axes == jop.exact_axes
        assert set(op.axes) == set(jop.axes)

    def test_candidates_match_jax_but_flash_block_k(self):
        """flash_attn's block_k takes the kv tiles the card's kernel is
        built for; every other axis keeps the reference's candidates."""
        for name in ("decode_attn", "paged_attn"):
            assert dict(api.get_op(name).axes) == \
                dict(japi.get_op(name).axes)
            assert dict(api.get_op(name).default) == \
                dict(japi.get_op(name).default)
        op, jop = api.get_op("flash_attn"), japi.get_op("flash_attn")
        assert op.axes["block_q"] == jop.axes["block_q"]
        assert op.default["block_q"] == jop.default["block_q"]
        assert op.axes["block_k"] == (32, 64, 128)
        assert op.default["block_k"] == 64

    @pytest.mark.parametrize("name", ["decode_attn", "paged_attn"])
    def test_decode_shape_keys_match_jax(self, name):
        q, k, v, lens = _decode_inputs(4, 1)
        (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
        key = api.get_op(name).shape_key(tq, tk, tv, torch.from_numpy(lens))
        assert key == japi.get_op(name).shape_key(jq, jk, jv,
                                                  jnp.asarray(lens))
        assert key == "b4h8kv2s256d64:bfloat16"

    def test_flash_shape_key_matches_jax(self):
        q, k, v = _flash_inputs(4, 1)
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        key = api.get_op("flash_attn").shape_key(
            *map(torch.from_numpy, (q, k, v)), causal=True)
        assert key == japi.get_op("flash_attn").shape_key(jq, jk, jv,
                                                          causal=True)
        assert key == "b1h8kv2s256d64:float32"
