"""The serve steps against the JAX package's, family by family.

For each family's ``smoke_config`` (batch 2, prompt 8, horizon 12), the
same weights (the reference's ``init_params``, carried across by
``params_from_jax``) and the same tokens go through the reference's
jitted ``make_prefill_step``/``make_decode_step`` and the port's, in f32
(the weights cast up) and in bf16, under every ``kv_storage`` the family
supports and both activation transports. The decode step starts from the
reference's own grown and storage-encoded cache (``cache_from_jax``), so
each step is compared alone. ``hubert-xlarge`` goes through
``make_encode_step``.

Bars, as the model tests' (``tests/test_torch_models.py``): f32 logits
within ``F32_TOL`` (2e-6) of their scale, max(1, max |logit|), and bf16
logits within ``ROW_REL_BAR`` (2e-2) of it. Measured on the CPU: f32 under
1.2e-6 (xLSTM, then MLA at 9.3e-7; the dense families under 6e-7), bf16
under 1.9e-2 (hymba's hybrid layer; XLA and eager torch round bf16 at
different points, a few bf16 ulps of the largest logit).
Caches, in f32: a bf16 leaf within one bf16 rounding of the reference's
(2**-7 of the leaf's scale; the f32 values that round to it agree to
~1e-7), an f32 leaf (recurrent state) and every scale leaf within
``F32_TOL`` of its scale, an int8 leaf dequantized within one
quantization step of its block, an f8 leaf within one e4m3 rounding
(2**-3 of the scale). In bf16 the two frameworks round at different
points (XLA keeps f32 across a fused chain of elementwise ops), so each
bar widens to ``ROW_REL_BAR`` of the leaf's scale. The structure and
dtypes are the reference's exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.dist import collectives as ref_coll
from repro.launch.serve import grow_cache as ref_grow_cache
from repro.models import transformer as ref_tf
from repro.train import step as ref_step
from repro_torch.configs import smoke_config
from repro_torch.dist import collectives as coll
from repro_torch.models import cache_from_jax, params_from_jax
from repro_torch.models.common import tree_leaves
from repro_torch.train import step as step_lib

F32_TOL = 2e-6
ROW_REL_BAR = 2e-2
B, S0, TOTAL = 2, 8, 12

DECODERS = ("granite-3-8b", "qwen3-moe-30b-a3b", "minicpm3-4b", "hymba-1.5b",
            "internvl2-2b", "xlstm-125m")
ATTENTION = ("granite-3-8b", "qwen3-moe-30b-a3b", "minicpm3-4b",
             "internvl2-2b")


def cases():
    out = []
    for arch in DECODERS:
        storages = ("bf16", "int8", "f8") if arch in ATTENTION else ("bf16",)
        for dtype in ("f32", "bf16"):
            for storage in storages:
                for act in ("bf16", "int8"):
                    if act == "int8" and (storage != "bf16" or dtype != "f32"):
                        continue
                    out.append((arch, dtype, storage, act))
    # both transports under each quantized storage in f32, and the int8
    # transport in bf16 for an attention and a hybrid family
    out += [(a, "f32", s, "int8") for a in ("granite-3-8b", "minicpm3-4b")
            for s in ("int8", "f8")]
    out += [(a, "bf16", "bf16", "int8") for a in ("granite-3-8b",
                                                  "hymba-1.5b")]
    return out


@pytest.fixture(scope="module")
def weights():
    memo = {}

    def get(arch, dtype):
        if arch not in memo:
            cfg = ref_smoke_config(arch)
            memo[arch] = ref_tf.init_params(cfg, jax.random.PRNGKey(4))
        p = memo[arch]
        if dtype == "f32":
            p = jax.tree.map(lambda x: x.astype(jnp.float32)
                             if x.dtype == jnp.bfloat16 else x, p)
        return p, params_from_jax(smoke_config(arch),
                                  jax.tree.map(np.asarray, p), device="cpu")
    return get


def inputs(cfg, dtype, seed=0):
    rng = np.random.default_rng(seed)
    n = S0 - cfg.n_vision_tokens if cfg.frontend == "vit_patches" else S0
    nb = {"tokens": rng.integers(0, cfg.vocab, (B, n), dtype=np.int32)}
    if cfg.frontend == "vit_patches":
        x = rng.standard_normal((B, cfg.n_vision_tokens, ref_tf.VIT_HIDDEN))
        nb["patches"] = np.asarray(jnp.asarray(x, jnp.float32)
                                   .astype(jnp.bfloat16), np.float32)
    if cfg.frontend == "audio_frames":
        x = rng.standard_normal((B, S0, ref_tf.AUDIO_HIDDEN))
        nb["frames"] = np.asarray(jnp.asarray(x, jnp.float32)
                                  .astype(jnp.bfloat16), np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jb = {k: jnp.asarray(v, jdt) if v.dtype == np.float32 else jnp.asarray(v)
          for k, v in nb.items()}
    tb = {k: torch.from_numpy(v).to(tdt) if v.dtype == np.float32
          else torch.from_numpy(v) for k, v in nb.items()}
    return jb, tb


def assert_logits(got: torch.Tensor, want, dtype):
    w = np.asarray(want, np.float32)
    g = got.float().numpy()
    assert g.shape == w.shape
    scale = max(1.0, float(np.abs(w).max()))
    err = float(np.abs(g - w).max())
    bar = F32_TOL if dtype == "f32" else ROW_REL_BAR
    assert err <= bar * scale, (err, scale, bar)


def _flat(tree):
    """(name, leaf) pairs in leaf order, names from the dict keys."""
    if isinstance(tree, dict) and "blocks" in tree:
        return [(k, blk[k]) for blk in tree["blocks"] for k in sorted(blk)]
    return [(k, tree[k]) for k in sorted(tree)]


def assert_cache(got, want, dtype):
    g, w = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert [k for k, _ in g] == [k for k, _ in w]
    by_name = dict(w)
    for (name, gl), (_, wl) in zip(g, w):
        assert tuple(gl.shape) == wl.shape, name
        assert str(gl.dtype).split(".")[-1] == wl.dtype.name, \
            (name, gl.dtype, wl.dtype)
        wf = np.asarray(wl, np.float32)
        gf = gl.float().numpy()
        scale = max(1e-30, float(np.abs(wf).max()))
        if wl.dtype == np.int8:
            # one quantization step of each block: |q| <= 127 per block
            ws = np.asarray(by_name[name + "_scale"], np.float32)
            gs = dict(g)[name + "_scale"].numpy()
            nb = ws.shape[-1]
            deq_w = (wf.reshape(wf.shape[:-1] + (nb, -1)) * ws[..., None])
            deq_g = (gf.reshape(gf.shape[:-1] + (nb, -1)) * gs[..., None])
            slack = 0.0 if dtype == "f32" else ROW_REL_BAR * np.abs(deq_w).max()
            assert np.all(np.abs(deq_g - deq_w)
                          <= 1.01 * ws[..., None] + slack + 1e-30), name
            continue
        tol = {"bfloat16": 2.0 ** -7, "float8_e4m3fn": 2.0 ** -3}.get(
            wl.dtype.name, F32_TOL)
        if dtype == "bf16":
            tol = max(tol, ROW_REL_BAR)
        err = float(np.abs(gf - wf).max())
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("arch,dtype,storage,act", cases())
def test_prefill_and_decode_match_reference(arch, dtype, storage, act,
                                            weights):
    rcfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    rp, tp = weights(arch, dtype)
    jb, tb = inputs(rcfg, dtype)
    lg_w, c_w = jax.jit(ref_step.make_prefill_step(rcfg, act))(rp, jb)
    lg_g, c_g = step_lib.make_prefill_step(cfg, act)(tp, tb)
    assert_logits(lg_g, lg_w, dtype)
    assert_cache(c_g, c_w, dtype)

    # decode from the reference's own cache, grown and storage-encoded
    c_w = ref_grow_cache(c_w, ref_tf.abstract_cache(rcfg, B, TOTAL))
    c_w = jax.jit(lambda c: ref_tf.quantize_cache(c, storage))(c_w) \
        if "blocks" not in c_w else c_w
    tok = np.array(jnp.argmax(lg_w, -1), np.int32)[:, None]
    pos = np.array([S0, S0 - 3], np.int32) if arch in ATTENTION[:3] \
        else np.asarray(S0, np.int32)
    decode_w = jax.jit(ref_step.make_decode_step(rcfg, TOTAL, act, storage))
    decode_g = step_lib.make_decode_step(cfg, TOTAL, act, storage)
    lg_w, n_w = decode_w(rp, c_w, {"tokens": jnp.asarray(tok),
                                   "pos": jnp.asarray(pos)})
    start = cache_from_jax(jax.tree.map(np.asarray, c_w), device="cpu")
    kept = [t.clone() for t in tree_leaves(start)]
    lg_g, n_g = decode_g(tp, start, {"tokens": torch.from_numpy(tok),
                                     "pos": torch.from_numpy(pos)})
    assert_logits(lg_g, lg_w, dtype)
    assert_cache(n_g, n_w, dtype)
    for a, b in zip(tree_leaves(start), kept):     # the input is unchanged
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)) \
            if a.dtype == coll.F8_DTYPE else torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("act", ["bf16", "int8"])
def test_encode_step_matches_reference(dtype, act, weights):
    arch = "hubert-xlarge"
    rcfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    rp, tp = weights(arch, dtype)
    jb, tb = inputs(rcfg, dtype)
    want = jax.jit(ref_step.make_encode_step(rcfg, act))(rp, jb)
    got = step_lib.make_encode_step(cfg, act)(tp, tb)
    assert_logits(got, want, dtype)


def test_int8_act_transport_changes_logits_as_in_the_reference(weights):
    """On one device the int8 gather still rounds: the two transports'
    logits differ, by the same amount in both packages."""
    arch = "granite-3-8b"
    rcfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    rp, tp = weights(arch, "f32")
    jb, tb = inputs(rcfg, "f32", seed=3)
    w = {a: np.asarray(jax.jit(ref_step.make_prefill_step(rcfg, a))(rp, jb)[0])
         for a in ("bf16", "int8")}
    g = {a: step_lib.make_prefill_step(cfg, a)(tp, tb)[0].numpy()
         for a in ("bf16", "int8")}
    d_w, d_g = np.abs(w["int8"] - w["bf16"]), np.abs(g["int8"] - g["bf16"])
    assert d_w.max() > 1e-4 and d_g.max() > 1e-4
    np.testing.assert_allclose(d_g, d_w, atol=F32_TOL * np.abs(w["bf16"]).max())


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m"])
@pytest.mark.parametrize("storage", ["int8", "f8"])
def test_recurrent_families_refuse_quantized_storage(arch, storage):
    with pytest.raises(NotImplementedError, match="kv_storage") as got:
        step_lib.make_decode_step(smoke_config(arch), 16, "bf16", storage)
    with pytest.raises(NotImplementedError) as want:
        ref_step.make_decode_step(ref_smoke_config(arch), 16, "bf16", storage)
    assert str(got.value) == str(want.value)


def test_step_factories_refuse_unknown_modes():
    cfg = smoke_config("granite-3-8b")
    with pytest.raises(ValueError, match="act_transport"):
        step_lib.make_prefill_step(cfg, "fp4")
    with pytest.raises(ValueError, match="kv_storage"):
        step_lib.make_decode_step(cfg, 16, "bf16", "int4")
    assert step_lib.ACT_TRANSPORTS == ref_step.ACT_TRANSPORTS
    assert step_lib.KV_STORAGES == ref_step.KV_STORAGES
    assert step_lib.CACHE_TRANSFERS == ref_step.CACHE_TRANSFERS
    assert coll.F8_MAX == ref_coll.F8_MAX and coll.ACT_BLOCK == ref_coll.ACT_BLOCK
