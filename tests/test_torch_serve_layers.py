"""The serve path's layers, collectives and state stores against the JAX
package's, on the same inputs made with numpy from a seed.

Bit-exact: the cache bookkeeping (``cache_slot_positions``, ``ring_update``
with full and ring caches, scalar and per-row positions), the int8
quantizers (``quantize_``/``dequantize_int8_lastdim``, the ``_seqaxis``
pair, ``stream_int8``, ``stream_slot_int8``, ``stream_row_int8``), the f8
cast over all 65,536 bf16 bit patterns, ``act_gather`` under the int8
transport (against the reference on its one-device mesh), and every
``StateStore``/``PagedStateStore`` operation (admit, free, gather,
scatter, paged admission), each leaf compared as raw bits.

f32 math: ``decode_attention`` with bf16, int8 and f8 caches and per-row
positions within 2e-6 of the output's scale (measured on the CPU: under
3e-7), and ``paged_decode_attention`` bit-equal to the dense read in the
port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.dist import collectives as ref_coll
from repro.dist import sharding as ref_shd
from repro.launch.mesh import make_local_mesh as ref_local_mesh
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import registry as ref_registry
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.dist import collectives as coll
from repro_torch.models import attention, cache_from_jax, common, registry
from repro_torch.models.common import tree_leaves

ATTN_TOL = 2e-6


def to_np(x) -> np.ndarray:
    """A tensor or jax array as numpy, bf16 and f8 as their raw bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        if x.dtype == coll.F8_DTYPE:
            return x.view(torch.uint8).numpy()
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    if a.dtype.name == "float8_e4m3fn":
        return a.view(np.uint8)
    return a


def assert_bits(got, want, what=""):
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (what, g.shape, w.shape,
                                                       g.dtype, w.dtype)
    assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), what


def assert_trees_bits(got, want):
    g = tree_leaves(got)
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert_bits(a, b, i)


def f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# cache bookkeeping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total,size", [(16, 16), (17, 16), (40, 8)])
@pytest.mark.parametrize("pos", [0, 5, 15, 23, [0, 7, 15, 31]])
def test_cache_slot_positions_match(total, size, pos):
    want = ref_attn.cache_slot_positions(total, size, jnp.asarray(pos))
    got = attention.cache_slot_positions(total, size, pos)
    assert_bits(got, want)


@pytest.mark.parametrize("dtype", ["bf16", "f8", "int8"])
@pytest.mark.parametrize("pos", [3, 11, [0, 5, 9]])
def test_ring_update_matches(dtype, pos):
    rng = np.random.default_rng(3)
    buf = f32(rng, 3, 8, 2, 4)
    new = f32(rng, 3, 1, 2, 4)
    jdt = {"bf16": jnp.bfloat16, "f8": ref_coll.F8_DTYPE,
           "int8": jnp.int8}[dtype]
    tdt = {"bf16": torch.bfloat16, "f8": coll.F8_DTYPE,
           "int8": torch.int8}[dtype]
    if dtype == "int8":
        # the decode step writes int8 values the quantizer made
        buf = np.clip(np.round(buf * 40), -127, 127)
        new = np.clip(np.round(new * 40), -127, 127).astype(np.int8)
    want = ref_attn.ring_update(jnp.asarray(buf).astype(jdt),
                                jnp.asarray(new), jnp.asarray(pos))
    got = attention.ring_update(torch.from_numpy(buf).to(tdt),
                                torch.from_numpy(new), pos)
    assert_bits(got, want)


# ---------------------------------------------------------------------------
# collectives, bit for bit
# ---------------------------------------------------------------------------

def test_cast_f8_every_bf16_pattern():
    pats = np.arange(1 << 16, dtype=np.uint16)
    want = jax.jit(ref_coll.cast_f8)(
        jnp.asarray(pats.view(np.int16)).view(jnp.bfloat16))
    got = coll.cast_f8(torch.from_numpy(pats.view(np.int16))
                       .view(torch.bfloat16))
    assert_bits(got, want)
    # the upcast: equal values, NaN where the reference has NaN (a NaN's
    # payload bits are not a value)
    np.testing.assert_array_equal(coll.uncast_f8(got).numpy(),
                                  np.asarray(jax.jit(ref_coll.uncast_f8)(want)))


@pytest.mark.parametrize("shape", [(3, 5, 512), (2, 7, 96), (4, 256)])
def test_int8_lastdim_roundtrip_bits(shape):
    x = f32(np.random.default_rng(5), *shape, scale=3.0)
    x[0, ..., :7] = 0.0                         # an all-zero row part
    q_w, s_w = jax.jit(ref_coll.quantize_int8_lastdim)(jnp.asarray(x))
    q_g, s_g = coll.quantize_int8_lastdim(torch.from_numpy(x))
    assert_bits(q_g, q_w)
    assert_bits(s_g, s_w)
    assert_bits(coll.dequantize_int8_lastdim(q_g, s_g),
                jax.jit(ref_coll.dequantize_int8_lastdim)(q_w, s_w))
    assert coll.lastdim_blocks(shape[-1]) == ref_coll.lastdim_blocks(shape[-1])


@pytest.mark.parametrize("seq_axis,shape", [(1, (2, 512, 3, 8)),
                                            (2, (2, 3, 40, 8))])
def test_int8_seqaxis_and_stream_bits(seq_axis, shape):
    x = f32(np.random.default_rng(7), *shape)
    q_w, s_w = jax.jit(ref_coll.quantize_int8_seqaxis,
                       static_argnums=1)(jnp.asarray(x), seq_axis)
    q_g, s_g = coll.quantize_int8_seqaxis(torch.from_numpy(x), seq_axis)
    assert_bits(q_g, q_w)
    assert_bits(s_g, s_w)
    assert_bits(coll.dequantize_int8_seqaxis(q_g, s_g, seq_axis),
                jax.jit(ref_coll.dequantize_int8_seqaxis,
                        static_argnums=2)(q_w, s_w, seq_axis))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    axes = ("batch", "kv_seq", "kv_heads", None) if seq_axis == 1 \
        else ("layers", "batch", "kv_seq", None)
    want = jax.jit(lambda t: ref_coll.stream_int8(t, *axes,
                                                  seq_axis=seq_axis))(xb)
    got = coll.stream_int8(torch.from_numpy(x).bfloat16(), *axes,
                           seq_axis=seq_axis)
    assert_bits(got, want)


@pytest.mark.parametrize("slot", [0, 2, 9])
def test_stream_slot_and_row_int8_bits(slot):
    rng = np.random.default_rng(11)
    leaf = jnp.asarray(f32(rng, 2, 4, 16, 2, 8)).astype(jnp.bfloat16)
    slc = jnp.asarray(f32(rng, 2, 1, 16, 2, 8)).astype(jnp.bfloat16)
    axes = ("layers", "batch", "kv_seq", "kv_heads", None)
    want = jax.jit(lambda c, n, s: ref_coll.stream_slot_int8(
        c, n, s, *axes, seq_axis=2, batch_axis=1))(leaf, slc, slot)
    got = coll.stream_slot_int8(cache_from_jax(np.asarray(leaf), device="cpu"),
                                cache_from_jax(np.asarray(slc), device="cpu"),
                                slot, *axes, seq_axis=2, batch_axis=1)
    assert_bits(got, want)          # slot 9 clamps to the last row in both
    row_leaf = jnp.asarray(f32(rng, 4, 24))
    row = jnp.asarray(f32(rng, 1, 24))
    want = jax.jit(lambda c, n, s: ref_coll.stream_row_int8(
        c, n, s, "batch", None))(row_leaf, row, slot)
    got = coll.stream_row_int8(torch.from_numpy(np.asarray(row_leaf)),
                               torch.from_numpy(np.asarray(row)), slot,
                               "batch", None)
    assert_bits(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8", "f8"])
def test_act_gather_int8_matches_one_device_mesh(dtype):
    x = f32(np.random.default_rng(13), 2, 6, 512)
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    if dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    elif dtype == "int8":
        jx, tx = jnp.asarray(np.round(x * 30)).astype(jnp.int8), \
            torch.from_numpy(np.round(x * 30)).to(torch.int8)
    elif dtype == "f8":
        jx, tx = ref_coll.cast_f8(jx), coll.cast_f8(tx)
    mesh = ref_local_mesh()

    def ref_fn(t):
        with ref_shd.axis_rules(mesh, ref_shd.PRESETS["serve_sp"]), \
                ref_coll.act_transport_scope("int8"):
            return ref_coll.act_gather(t, "batch", None, "act_embed")
    want = jax.jit(ref_fn)(jx)
    with coll.act_transport_scope("int8"):
        got = coll.act_gather(tx, "batch", None, "act_embed")
    assert_bits(got, want)
    if dtype in ("f32", "bf16"):
        assert not np.array_equal(to_np(got), to_np(tx))   # values rounded
    # outside any scope, and under bf16, the gather is the identity
    assert coll.act_gather(tx) is tx
    with coll.act_transport_scope("bf16"):
        assert coll.act_gather(tx, "batch", None, None) is tx


def test_scopes_nest_and_refuse_unknown_modes():
    assert coll.current_act_transport() is None
    assert coll.current_kv_storage() == "bf16"
    with coll.act_transport_scope("int8"), coll.kv_storage_scope("f8"):
        assert coll.current_act_transport() == "int8"
        assert coll.current_kv_storage() == "f8"
        with coll.kv_storage_scope(None):
            assert coll.current_kv_storage() == "bf16"
        assert coll.current_kv_storage() == "f8"
    assert coll.current_act_transport() is None
    with pytest.raises(ValueError, match="act_transport"):
        coll.act_transport_scope("fp4")
    with pytest.raises(ValueError, match="kv_storage"):
        coll.kv_storage_scope("int4")


def test_update_slice_clamps_like_dynamic_update_slice():
    buf = np.arange(24, dtype=np.float32).reshape(4, 6)
    upd = -np.ones((2, 3), np.float32)
    for start in [(0, 0), (3, 5), (-1, 2), (9, 9)]:
        want = jax.lax.dynamic_update_slice(jnp.asarray(buf), jnp.asarray(upd),
                                            start)
        got = coll.update_slice(torch.from_numpy(buf), torch.from_numpy(upd),
                                start)
        assert_bits(got, want, start)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def _attn_case(rng, b=3, s=24, hkv=2, group=2, d=256):
    q = f32(rng, b, 1, hkv * group, d)
    k = f32(rng, b, s, hkv, d)
    v = f32(rng, b, s, hkv, d)
    return q, k, v


def _close(got, want, tol=ATTN_TOL):
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(w).max()))
    err = float(np.abs(g - w).max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("storage", ["bf16", "int8", "f8"])
@pytest.mark.parametrize("pos", [17, [3, 23, 11]])
@pytest.mark.parametrize("ring", [False, True])
def test_decode_attention_matches(storage, pos, ring):
    rng = np.random.default_rng(17)
    q, k, v = _attn_case(rng)
    size = 8 if ring else 24
    k, v = k[:, :size], v[:, :size]
    total = 40 if ring else 24
    kp_w = ref_attn.cache_slot_positions(total, size, jnp.asarray(pos))
    kp_g = attention.cache_slot_positions(total, size, pos)
    kw, vw = jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16)
    kg, vg = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    sw = sg = (None, None)
    if storage == "int8":
        quant = jax.jit(ref_coll.quantize_int8_lastdim)
        (kw, ksw), (vw, vsw) = quant(kw), quant(vw)
        (kg, ksg), (vg, vsg) = (coll.quantize_int8_lastdim(kg),
                                coll.quantize_int8_lastdim(vg))
        sw, sg = (ksw, vsw), (ksg, vsg)
        assert_bits(kg, kw)
    elif storage == "f8":
        kw, vw = jax.jit(ref_coll.cast_f8)(kw), jax.jit(ref_coll.cast_f8)(vw)
        kg, vg = coll.cast_f8(kg), coll.cast_f8(vg)
    want = jax.jit(ref_common.decode_attention)(
        jnp.asarray(q), kw, vw, kp_w, jnp.asarray(pos), *sw)
    got = common.decode_attention(torch.from_numpy(q), kg, vg, kp_g, pos, *sg)
    assert got.shape == tuple(want.shape) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("storage", ["bf16", "int8"])
def test_paged_decode_attention_equals_dense_read(storage):
    rng = np.random.default_rng(19)
    q, k, v = _attn_case(rng, b=3, s=32)
    page = 8
    kt, vt = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    ks = vs = None
    if storage == "int8":
        (kt, ks), (vt, vs) = (coll.quantize_int8_lastdim(kt),
                              coll.quantize_int8_lastdim(vt))
    pos = [9, 31, 0]
    kpos = attention.cache_slot_positions(33, 32, pos)
    dense = common.decode_attention(torch.from_numpy(q), kt, vt, kpos, pos,
                                    ks, vs)
    # scatter every row's live pages to a shuffled pool; unallocated -1
    n_pages = 3 * 32 // page
    perm = np.random.default_rng(1).permutation(n_pages)
    pt = perm.reshape(3, 4).astype(np.int32)
    pt[0, 2:] = -1                           # row 0 lives in pages 0-1
    pt[2, 1:] = -1

    def pool_of(x):
        pool = torch.zeros((n_pages, page) + tuple(x.shape[2:]), dtype=x.dtype)
        pages = x.reshape((n_pages, page) + tuple(x.shape[2:]))
        for i, j in enumerate(pt.reshape(-1)):
            if j >= 0:
                pool[j] = pages[i]
        return pool

    got = attention.paged_decode_attention(
        torch.from_numpy(q), pool_of(kt), pool_of(vt), torch.from_numpy(pt),
        kpos, pos, None if ks is None else pool_of(ks),
        None if vs is None else pool_of(vs))
    assert torch.equal(got, dense)


# ---------------------------------------------------------------------------
# registry: capabilities and the state stores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_capabilities_match_reference(arch):
    assert tuple(ARCH_IDS) == tuple(REF_ARCH_IDS)
    for port_cfg, ref_cfg in ((smoke_config, ref_smoke_config),
                              (get_config, ref_get_config)):
        want = ref_registry.capabilities(ref_cfg(arch))
        got = registry.capabilities(port_cfg(arch))
        assert got.__dict__ == want.__dict__, arch
    for fam in ("dense", "moe", "mla", "vlm", "encoder_audio", "hybrid",
                "ssm_xlstm"):
        assert registry.capabilities(fam).__dict__ == \
            ref_registry.capabilities(fam).__dict__
    with pytest.raises(ValueError, match="unknown family"):
        registry.capabilities("rnn")


@pytest.mark.parametrize("arch,cap,flag", [
    ("xlstm-125m", "ragged", "ragged prompt_lens"),
    ("hymba-1.5b", "quantized_storage", "kv_storage='int8'"),
    ("hymba-1.5b", "paged", "--paged"),
    ("xlstm-125m", "paged", "--paged"),
])
def test_require_refusals_read_as_the_reference(arch, cap, flag):
    with pytest.raises(NotImplementedError) as got:
        registry.require(smoke_config(arch), cap, flag)
    with pytest.raises(NotImplementedError) as want:
        ref_registry.require(ref_smoke_config(arch), cap, flag)
    assert str(got.value) == str(want.value)
    registry.require(smoke_config("granite-3-8b"), cap, flag)


def _row_of(cfg, rng, total, dtype=np.float32):
    """A random [1, total] bf16 state slice of ``cfg``'s cache layout, as
    numpy (bf16 rounded) per leaf."""
    from repro.models import transformer as ref_tf
    abs_row = ref_tf.abstract_cache(cfg, 1, total)
    return jax.tree.map(
        lambda s: np.asarray(jnp.asarray(f32(rng, *s.shape)).astype(s.dtype)),
        abs_row)


@pytest.mark.parametrize("arch", ["granite-3-8b", "minicpm3-4b",
                                  "hymba-1.5b", "xlstm-125m"])
@pytest.mark.parametrize("storage", ["bf16", "int8", "f8"])
@pytest.mark.parametrize("transfer", ["bf16", "int8"])
def test_state_store_admit_free_bits(arch, storage, transfer):
    rcfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    if not registry.capabilities(cfg).quantized_storage and storage != "bf16":
        with pytest.raises(NotImplementedError, match="kv_storage"):
            registry.state_store(cfg, 3, 16, kv_storage=storage)
        return
    rs = ref_registry.state_store(rcfg, 3, 16, kv_storage=storage)
    ps = registry.state_store(cfg, 3, 16, kv_storage=storage)
    rng = np.random.default_rng(23)
    row_a, row_b = _row_of(rcfg, rng, 16), _row_of(rcfg, rng, 16)
    st_w = rs.init_state()
    st_g = ps.init_state("cpu")
    assert_trees_bits(st_g, st_w)
    for slot, row in ((0, row_a), (2, row_b), (0, row_b)):
        st_w = jax.jit(lambda s, r, i: rs.admit_row(s, r, i,
                                                    transfer=transfer))(
            st_w, jax.tree.map(jnp.asarray, row), slot)
        st_g = ps.admit_row(st_g, cache_from_jax(row, device="cpu"), slot,
                            transfer=transfer)
        assert_trees_bits(st_g, st_w)
    kept = [t.clone() for t in tree_leaves(st_g)]
    st_w = rs.free_row(st_w, 2)
    freed = ps.free_row(st_g, 2)
    assert_trees_bits(freed, st_w)
    for a, b in zip(tree_leaves(st_g), kept):   # the input is unchanged
        assert torch.equal(a.view(torch.uint8) if a.dtype == coll.F8_DTYPE
                           else a, b.view(torch.uint8)
                           if b.dtype == coll.F8_DTYPE else b)


@pytest.mark.parametrize("arch", ["granite-3-8b", "minicpm3-4b"])
@pytest.mark.parametrize("storage", ["bf16", "int8", "f8"])
def test_paged_state_store_bits(arch, storage):
    rcfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    kw = dict(kv_storage=storage, page=4, pool_pages=10)
    rs = ref_registry.paged_state_store(rcfg, 3, 16, **kw)
    ps = registry.paged_state_store(cfg, 3, 16, **kw)
    assert ps.page_bytes() == rs.page_bytes()
    assert {k: v.shape for k, v in ps.abstract_state().items()} == \
        {k: v.shape for k, v in rs.abstract_state().items()}
    assert ps.state_axes() == rs.state_axes()
    rng = np.random.default_rng(29)
    pool_w, pool_g = rs.init_state(), ps.init_state("cpu")
    pt = ps.init_page_table()
    for slot, n_live, pages, transfer in ((1, 2, [7, 2], "int8"),
                                          (0, 3, [0, 5, 9], "bf16")):
        slc = _row_of(rcfg, rng, 4 * n_live)
        pool_w = jax.jit(lambda p, c, i, t=transfer: rs.admit_pages(
            p, c, i, transfer=t))(pool_w, jax.tree.map(jnp.asarray, slc),
                                  jnp.asarray(pages, jnp.int32))
        pool_g = ps.admit_pages(pool_g, cache_from_jax(slc, device="cpu"),
                                np.asarray(pages, np.int32),
                                transfer=transfer)
        pt[slot, :n_live] = pages
        assert_trees_bits(pool_g, pool_w)
    dense_w = jax.jit(rs.gather_dense)(pool_w, jnp.asarray(pt))
    dense_g = ps.gather_dense(pool_g, pt)
    assert_trees_bits(dense_g, dense_w)
    # a step's worth of change to the dense view, then back into the pool
    bumped = {k: np.asarray(v) for k, v in dense_w.items()}
    for k in bumped:
        bumped[k] = np.flip(bumped[k], axis=2).copy()
    back_w = jax.jit(rs.scatter_dense)(
        pool_w, jax.tree.map(jnp.asarray, bumped), jnp.asarray(pt))
    back_g = ps.scatter_dense(pool_g, cache_from_jax(bumped, device="cpu"),
                              pt)
    assert_trees_bits(back_g, back_w)


def test_paged_store_refusals_read_as_the_reference():
    cfg, rcfg = smoke_config("granite-3-8b"), ref_smoke_config("granite-3-8b")
    for kw in (dict(page=5), dict(page=4, pool_pages=1), dict(page=0)):
        with pytest.raises(ValueError) as got:
            registry.paged_state_store(cfg, 2, 16, **kw)
        with pytest.raises(ValueError) as want:
            ref_registry.paged_state_store(rcfg, 2, 16, **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# a fault of the reference: prefill of a ragged-tile length
# ---------------------------------------------------------------------------

def test_prefill_of_a_length_the_reference_refuses(tmp_path):
    """The reference's blockwise attention asserts that a sequence longer
    than its 1024-block is a multiple of it, so its prefill of 1100
    tokens fails (and with it a fan-in readmission or a recurrent slot
    prefill of such a length). The port pads the last tile; its logits
    equal the reference's padded-buffer prefill of the same prompt (a
    2048 buffer with ``last_pos``, a path the reference serves) within
    the f32 bar."""
    from repro.models import transformer as ref_tf
    from repro.train import step as ref_step
    from repro_torch.models import params_from_jax
    from repro_torch.train import step as step_lib
    rcfg, cfg = ref_smoke_config("granite-3-8b"), smoke_config("granite-3-8b")
    rp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      ref_tf.init_params(rcfg, jax.random.PRNGKey(0)))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, rp), device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, 1100),
                                             dtype=np.int32)
    with pytest.raises(AssertionError):
        jax.jit(ref_step.make_prefill_step(rcfg))(rp, {"tokens": toks})
    buf = np.zeros((1, 2048), np.int32)
    buf[:, :1100] = toks
    want, _ = jax.jit(ref_step.make_prefill_step(rcfg))(
        rp, {"tokens": jnp.asarray(buf), "last_pos": jnp.asarray([1099])})
    got, cache = step_lib.make_prefill_step(cfg)(
        tp, {"tokens": torch.from_numpy(toks)})
    assert cache["k"].shape[2] == 1100
    _close(got, want)


def test_recompute_preemption_under_int8_storage_is_not_exact():
    """The reference's one failing test
    (``test_serve_fanin.py::TestPagedEngine::
    test_paged_eviction_quantized_storage_matches``) is not about pages:
    on its inputs the reference's unpaged contended int8 fan-in already
    differs from its uncontended int8 fan-in. A readmitted request's
    first token comes from the prefill's logits over exact K/V, where the
    uncontended run's came from a decode step over the dequantized cache,
    so recompute preemption equals an uncontended run only under bf16
    storage (which the reference's own test holds)."""
    from repro.launch import serve as ref_serve
    from repro.models import transformer as ref_tf
    cfg = ref_smoke_config("paper-lm-100m")
    params = ref_tf.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab, size=(4, 12)).astype(np.int32)
    kw = dict(max_new=8, prompt_lens=np.array([7, 12, 9, 11], np.int32),
              workers=2, kv_storage="int8")
    base = ref_serve.generate(cfg, params, prompts, **kw)
    contended = ref_serve.generate(
        cfg, params, prompts, slots=2, evict="priority",
        priorities=np.array([1, 1, 0, 0], np.int32), **kw)
    assert ref_serve._generate_fanin.last_stats["evictions"] > 0
    assert not (contended == base).all()
