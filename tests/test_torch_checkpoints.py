"""The port's checkpoints against the JAX package's, on the CPU.

The same tree -- ``paper-lm-100m``'s smoke weights in bf16 with an f32
leaf among them, an optimizer state with f32 moments, an int8 residual
tree and an int32 step, and the Trainer's Python-int step -- saved by both
packages gives the same object paths, byte-equal leaf objects and a
byte-equal ``MANIFEST.json``; a checkpoint of either package restores in
the other, bit for bit. Then the manager's own behaviour: ``partial_ok``
for a tree that gained ``"ef"``, GC with ``keep_last``, an async save
that is visible after ``wait()`` and holds the values of the moment it
was called, the manifest as the atomic publish, and
``bundle_merge_fn``'s blob byte-equal to the reference's.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import lst as ref_lst
from repro.configs import smoke_config as ref_smoke_config
from repro.lst import compaction as ref_comp
from repro.lst.workload import SimClock as RefClock
from repro.models import transformer as ref_tf
from repro.train import checkpoints as ref_ckpt
from repro_torch import lst
from repro_torch.lst import compaction as comp
from repro_torch.lst.workload import SimClock
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.interop import tree_from_numpy
from repro_torch.train import checkpoints as ckpt

CPU = torch.device("cpu")


def ref_tree(with_ef: bool = True, step: int = 7):
    """(params, opt_state, step) as the Trainer saves it, numpy-seeded."""
    params = ref_tf.init_params(ref_smoke_config("paper-lm-100m"),
                                jax.random.PRNGKey(0))
    params = dict(params, final_norm=params["final_norm"].astype(jnp.float32))
    rng = np.random.default_rng(0)

    def f32(p):
        return jnp.asarray(rng.standard_normal(p.shape).astype(np.float32))

    opt = {"mu": jax.tree.map(f32, params), "nu": jax.tree.map(f32, params),
           "step": jnp.int32(step)}
    if with_ef:
        opt["ef"] = jax.tree.map(f32, params)
    return params, opt, step


def port_tree(tree):
    """The same tree in the port: tensors with the same bits, the
    Python-int step kept as it is."""
    params, opt, step = tree
    return (tree_from_numpy(jax.tree.map(np.asarray, params), CPU),
            tree_from_numpy(jax.tree.map(np.asarray, opt), CPU), step)


def leaf_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_save_is_byte_equal_to_reference():
    tree = ref_tree()
    rs, ts = ref_lst.InMemoryStore(), lst.InMemoryStore()
    ref_ckpt.CheckpointManager(rs).save(7, tree)
    ckpt.CheckpointManager(ts).save(7, port_tree(tree))
    paths = rs.list("ckpt/")
    assert paths == ts.list("ckpt/") and len(paths) > 30
    for p in paths:
        assert ts.get(p) == rs.get(p), p
    man = json.loads(ts.get("ckpt/step-00000007/MANIFEST.json"))
    dtypes = {e["dtype"] for e in man["leaves"]}
    assert dtypes == {"bfloat16", "float32", "int32", "int64"}, dtypes
    keys = [e["key"] for e in man["leaves"]]
    assert "[0]['layers']['attn']['wq']" in keys and "[1]['step']" in keys \
        and keys[-1] == "[2]"
    assert man["treedef"].startswith("PyTreeDef(({")


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_restore_across_packages(direction):
    tree = ref_tree(step=11)
    ptree = port_tree(tree)
    store = lst.InMemoryStore() if direction == "jax-to-port" \
        else ref_lst.InMemoryStore()
    if direction == "jax-to-port":
        ref_ckpt.CheckpointManager(store).save(11, tree)
        like = tree_map(lambda t: torch.zeros_like(t)
                        if isinstance(t, torch.Tensor) else 0, ptree)
        got, step = ckpt.CheckpointManager(store).restore(like)
        got_leaves = tree_leaves(got)
    else:
        ckpt.CheckpointManager(store).save(11, ptree)
        like = jax.tree.map(jnp.zeros_like, (tree[0], tree[1], 0))
        got, step = ref_ckpt.CheckpointManager(store).restore(like)
        got_leaves = jax.tree.leaves(got)
    assert step == 11
    want = jax.tree.leaves(tree)
    assert len(got_leaves) == len(want)
    for g, w in zip(got_leaves, want):
        assert np.array_equal(leaf_bits(g), leaf_bits(w))
    if direction == "jax-to-port":
        assert got[0]["embed"].dtype == torch.bfloat16
        assert got[1]["step"].dtype == torch.int32
        assert int(got[2]) == 11


def test_partial_ok_for_a_tree_that_gained_ef():
    params, opt, _ = port_tree(ref_tree(with_ef=False))
    store = lst.InMemoryStore()
    mgr = ckpt.CheckpointManager(store)
    mgr.save(3, (params, opt))
    zeros = tree_map(torch.zeros_like, params)
    like = (zeros, {**tree_map(torch.zeros_like, opt),
                    "ef": tree_map(lambda p: p.float(), zeros)})
    with pytest.raises(KeyError):
        mgr.restore(like)
    (rp, ro), step = mgr.restore(like, partial_ok=True)
    assert step == 3
    assert all(bool((e == 0).all()) for e in tree_leaves(ro["ef"]))
    for a, b in zip(tree_leaves(opt["mu"]), tree_leaves(ro["mu"])):
        assert torch.equal(a, b)
    # the other way: dropping the saved residual is asked for, not silent
    mgr.save(4, (params, like[1]))
    with pytest.raises(KeyError):
        mgr.restore((zeros, tree_map(torch.zeros_like, opt)))
    (_, ro), _ = mgr.restore((zeros, tree_map(torch.zeros_like, opt)),
                             partial_ok=True)
    assert "ef" not in ro


def test_gc_keeps_last():
    mgr = ckpt.CheckpointManager(lst.InMemoryStore(), keep_last=2)
    for s in range(5):
        mgr.save(s, {"a": torch.zeros(3)})
    assert mgr.available_steps() == [3, 4]


def test_async_save_visible_after_wait_and_holds_its_moment():
    mgr = ckpt.CheckpointManager(lst.InMemoryStore())
    t = torch.arange(6, dtype=torch.float32)
    mgr.save(1, {"a": t}, blocking=False)
    t.mul_(-1.0)                         # a later step changes the tensor
    mgr.wait()
    assert mgr.available_steps() == [1]
    got, _ = mgr.restore({"a": torch.zeros(6)})
    assert torch.equal(got["a"], torch.arange(6, dtype=torch.float32))


def test_manifest_is_atomic_publish():
    store = lst.InMemoryStore()
    mgr = ckpt.CheckpointManager(store)
    mgr.save(1, {"a": torch.zeros(3)})
    store.delete("ckpt/step-00000001/MANIFEST.json")
    assert mgr.available_steps() == []
    with pytest.raises(FileNotFoundError):
        mgr.restore({"a": torch.zeros(3)})


def test_restore_takes_each_reference_leaf_dtype():
    mgr = ckpt.CheckpointManager(lst.InMemoryStore())
    mgr.save(2, {"w": torch.full((2, 2), 1.5), "n": 5})
    got, _ = mgr.restore({"w": torch.zeros((2, 2), dtype=torch.bfloat16),
                          "n": 0})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].float(), torch.full((2, 2), 1.5))
    assert int(got["n"]) == 5
    with pytest.raises(ValueError, match="shardings has 1 leaves"):
        mgr.restore({"w": torch.zeros(2, 2), "n": 0}, shardings=object())


def test_bundle_merge_blob_byte_equal_to_reference():
    def run(L, Clock, manager, comp_mod, tree):
        clock = Clock()
        store = L.InMemoryStore()
        cat = L.Catalog(store, now_fn=clock.now)
        table = cat.create_table("ckpt", "registry")
        table.now_fn = clock.now
        manager(store, keep_last=10, table=table).save(1, tree)
        n_before = table.file_count()
        tasks = comp_mod.plan_table(table, target_bytes=1 << 20)
        outs = []
        for t in tasks:
            r = comp_mod.execute_task(table, t, merge_fn=(
                ckpt.bundle_merge_fn if L is lst else ref_ckpt.bundle_merge_fn))
            assert r.success
        for f in table.current_files():
            outs.append((f.path, store.get(f.path)))
        return n_before, table.file_count(), outs

    ref_t = {"a": jnp.zeros(64), "b": jnp.ones((8, 8)), "c": 3}
    port_t = {"a": torch.zeros(64), "b": torch.ones((8, 8)), "c": 3}
    want = run(ref_lst, RefClock, ref_ckpt.CheckpointManager, ref_comp, ref_t)
    got = run(lst, SimClock, ckpt.CheckpointManager, comp, port_t)
    assert got[1] < got[0]
    assert got == want
