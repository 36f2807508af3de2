"""The port's training math against the JAX package's, one model per family.

Each case runs ``repro.models.transformer.forward(mode="train")`` and its
port on the same weights -- the reference's ``init_params``, carried across
by ``params_from_jax`` -- and the same batch, made with numpy from a seed to
the shapes of ``input_specs`` (``src/repro/configs/shapes.py:105-133``), at
each family's ``smoke_config``, seq 16, batch 2.

f32 (the weights cast up): the loss within 2e-6 x max(1, |loss|) and each
gradient leaf within 3e-5 x its largest magnitude + 1e-6, ten times what
was measured on the CPU (losses to 1.6e-7, leaves to 2.3e-6 of their
scale) and tighter than the 1e-5 and 1e-4 first set.

bf16: the loss and every metric within ``ROW_REL_BAR`` (2e-2) of the
reference's, relative to max(1, |value|) (measured: under 7e-4). The two
frameworks round bf16 gradients at different points (XLA keeps f32 across
a fused chain of elementwise ops, eager torch rounds each op), so their bf16
gradients differ by 1-7% of a leaf's scale, about as much as each differs
from the f32 gradient of the same weights (1-10%). The bar for gradients is
therefore that the port's bf16 gradients stand no farther from that f32
gradient than the reference's do: the largest leaf error, relative to the
leaf's scale, within 1.25 x the reference's + 1e-3.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import transformer as ref_tf
from repro_torch.configs import smoke_config
from repro_torch.models import TransformerLM, params_from_jax
from repro_torch.models import transformer as tf
from repro_torch.models.common import tree_leaves, tree_map

ARCHS = ("qwen3-moe-30b-a3b", "granite-3-8b", "minicpm3-4b", "hymba-1.5b",
         "hubert-xlarge", "internvl2-2b", "xlstm-125m")
BATCH, SEQ = 2, 16
ROW_REL_BAR = 2e-2
LOSS_TOL, GRAD_TOL, GRAD_FLOOR = 2e-6, 3e-5, 1e-6


def make_batch(cfg, batch: int, seq: int, seed: int) -> dict:
    """numpy arrays of ``input_specs``'s train shapes; float inputs are
    rounded to bf16 values, so the f32 and bf16 cases read the same."""
    rng = np.random.default_rng(seed)

    def floats(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32)

    out = {}
    n = seq - cfg.n_vision_tokens if cfg.frontend == "vit_patches" else seq
    if cfg.frontend == "audio_frames":
        out["frames"] = floats(batch, seq, ref_tf.AUDIO_HIDDEN)
        out["mask"] = rng.random((batch, seq)) < 0.3
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (batch, n), dtype=np.int32)
    if cfg.frontend == "vit_patches":
        out["patches"] = floats(batch, cfg.n_vision_tokens, ref_tf.VIT_HIDDEN)
    out["labels"] = rng.integers(0, cfg.vocab, (batch, n), dtype=np.int32)
    return out


def jax_batch(nb: dict, dtype) -> dict:
    return {k: jnp.asarray(v, dtype) if v.dtype == np.float32 else jnp.asarray(v)
            for k, v in nb.items()}


def torch_batch(nb: dict, dtype) -> dict:
    return {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in nb.items()}


def reference_run(cfg, params, batch):
    """(loss, metrics, grads) of the reference, all as numpy."""
    fn = jax.jit(jax.value_and_grad(
        lambda p: ref_tf.forward(cfg, p, batch, "train"), has_aux=True))
    (loss, metrics), grads = fn(params)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(lambda g: np.asarray(g, np.float32), grads))


def port_run(cfg, params, batch):
    """(loss, metrics, grads) of the port; a leaf the loss does not reach
    (``embed`` under the audio frontend) has a zero gradient, as in JAX."""
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    loss, metrics = tf.forward(cfg, params, batch)
    loss.backward()
    grads = tree_map(lambda t: (torch.zeros_like(t) if t.grad is None
                                else t.grad).float().numpy(), params)
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()}, grads)


def leaf_errors(got, want) -> list:
    """(max |got - want|, max |want|) for each pair of leaves."""
    out = []
    tree_map(lambda g, w: out.append((float(np.abs(g - w).max()),
                                      float(np.abs(w).max()))), got, want)
    return out


@pytest.fixture(scope="module")
def runs():
    """Per arch: the reference's bf16 weights, the batch, and the
    reference's f32 and bf16 runs (computed once, shared by the tests)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = ref_smoke_config(arch)
            params = ref_tf.init_params(cfg, jax.random.PRNGKey(0))
            p32 = jax.tree.map(lambda x: x.astype(jnp.float32), params)
            nb = make_batch(cfg, BATCH, SEQ, seed=1)
            cache[arch] = {
                "params": params, "p32": p32, "batch": nb,
                "f32": reference_run(cfg, p32, jax_batch(nb, jnp.float32)),
                "bf16": reference_run(cfg, params,
                                      jax_batch(nb, jnp.bfloat16)),
            }
        return cache[arch]

    return get


def port_params(arch, tree):
    return params_from_jax(smoke_config(arch),
                           jax.tree.map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_loss_metrics_and_grads_match_reference(arch, runs):
    r = runs(arch)
    ref_loss, ref_metrics, ref_grads = r["f32"]
    loss, metrics, grads = port_run(smoke_config(arch),
                                    port_params(arch, r["p32"]),
                                    torch_batch(r["batch"], torch.float32))
    assert abs(loss - ref_loss) <= LOSS_TOL * max(1.0, abs(ref_loss))
    assert sorted(metrics) == sorted(ref_metrics)
    for k, v in ref_metrics.items():
        assert abs(metrics[k] - v) <= LOSS_TOL * max(1.0, abs(v)), k
    for err, scale in leaf_errors(grads, ref_grads):
        assert err <= GRAD_TOL * scale + GRAD_FLOOR, (err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_metrics_and_grads_match_reference(arch, runs):
    r = runs(arch)
    ref_loss, ref_metrics, ref_grads = r["bf16"]
    params = port_params(arch, r["params"])
    assert all(t.dtype in (torch.bfloat16, torch.float32)
               for t in tree_leaves(params))
    loss, metrics, grads = port_run(smoke_config(arch), params,
                                    torch_batch(r["batch"], torch.bfloat16))
    assert abs(loss - ref_loss) <= ROW_REL_BAR * max(1.0, abs(ref_loss))
    assert sorted(metrics) == sorted(ref_metrics)
    for k, v in ref_metrics.items():
        assert abs(metrics[k] - v) <= ROW_REL_BAR * max(1.0, abs(v)), k
    # the f32 gradient of the same (bf16-valued) weights and inputs
    truth = r["f32"][2]
    port = max(e / s for e, s in leaf_errors(grads, truth) if s > 0)
    ref = max(e / s for e, s in leaf_errors(ref_grads, truth) if s > 0)
    assert port <= 1.25 * ref + 1e-3, (port, ref)


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen3-moe-30b-a3b"])
def test_remat_block_two_equals_one(arch, runs):
    """Two layers in one checkpointed unit give the gradients of one
    layer per unit: remat changes what is saved, not what is computed."""
    r = runs(arch)
    cfg1 = smoke_config(arch)
    cfg2 = dataclasses.replace(cfg1, remat_block=2)
    batch = torch_batch(r["batch"], torch.float32)
    loss1, m1, g1 = port_run(cfg1, port_params(arch, r["p32"]), batch)
    loss2, m2, g2 = port_run(cfg2, port_params(arch, r["p32"]), batch)
    assert abs(loss1 - loss2) <= 1e-6 * max(1.0, abs(loss1))
    for k in m1:
        assert abs(m1[k] - m2[k]) <= 1e-6 * max(1.0, abs(m1[k])), k
    for err, scale in leaf_errors(g2, g1):
        assert err <= 1e-6 * scale, (err, scale)


def test_transformer_lm_registers_the_tree_as_parameters(runs):
    arch = "hymba-1.5b"
    r = runs(arch)
    cfg = smoke_config(arch)
    params = port_params(arch, r["p32"])
    model = TransformerLM(cfg, params=params)
    leaves = tree_leaves(params)
    assert len(list(model.parameters())) == len(leaves)
    assert sum(p.numel() for p in model.parameters()) == \
        sum(t.numel() for t in leaves)
    sd = model.state_dict()
    assert "layers.attn.wq" in sd and "layers.ssm.a_log" in sd
    assert torch.equal(sd["layers.attn.wq"], params["layers"]["attn"]["wq"])
    batch = torch_batch(r["batch"], torch.float32)
    loss, metrics = model(batch)
    loss.backward()
    assert abs(float(loss.detach()) - r["f32"][0]) <= LOSS_TOL * max(1.0, r["f32"][0])
    assert all(p.grad is not None for p in model.parameters())
    tree = model.params()
    assert tree["layers"]["attn"]["wq"] is model.layers.attn.wq


def test_transformer_lm_xlstm_blocks_are_a_list():
    cfg = smoke_config("xlstm-125m")
    model = TransformerLM(cfg, seed=3, device="cpu")
    assert isinstance(model.blocks, torch.nn.ModuleList)
    assert len(model.blocks) == cfg.n_layers
    assert "blocks.1.r_gates" in model.state_dict()


def test_other_modes_wait_for_serving():
    """The serve modes run (``tests/test_torch_serve_steps.py`` holds
    them against the reference), the int8 MoE decode too: it sends its
    dispatch buffers through ``expert_a2a``, once per layer."""
    cfg = smoke_config("granite-3-8b")
    params = tf.init_params(cfg, seed=0, device="cpu")
    logits, cache = tf.forward(
        cfg, params, {"tokens": torch.zeros(1, 4, dtype=torch.int32)},
        mode="prefill")
    assert logits.shape == (1, cfg.vocab)
    assert cache["k"].shape == (cfg.n_layers, 1, 4, cfg.n_kv_heads,
                                cfg.head_dim)
    with pytest.raises(ValueError, match="unknown mode"):
        tf.forward(cfg, params, {"tokens": torch.zeros(1, 4, dtype=torch.int32)},
                   mode="generate")
    from repro_torch.dist import collectives
    from repro_torch.kernels.expert_a2a import ops as a2a_ops
    moe_cfg = smoke_config("qwen3-moe-30b-a3b")
    moe_params = tf.init_params(moe_cfg, seed=0, device="cpu")
    cache = tf.init_cache(moe_cfg, 1, 8, device="cpu")
    batch = {"tokens": torch.zeros(1, 1, dtype=torch.int32),
             "pos": torch.tensor(3, dtype=torch.int32)}
    a2a_ops.reset_calls()
    with collectives.act_transport_scope("int8"):
        logits, _ = tf.forward(moe_cfg, moe_params, batch, mode="decode",
                               cache=cache, cache_len_total=8)
    assert logits.shape == (1, moe_cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all())
    assert a2a_ops.calls() == moe_cfg.n_layers
