"""The port's sharding rules against the JAX package's, and their
placements on a DeviceMesh.

``resolve_spec`` must give the reference's ``PartitionSpec`` (as a tuple)
for every leaf of every config's ``param_axes``, under every preset, on
the production meshes ``(16, 16)`` and ``(2, 16, 16)`` and the small
``(4, 2)`` and ``(2, 2)``: the reference resolves on JAX's
``AbstractMesh``, the port on a ``{axis: size}`` mapping, no ranks on
either side. The rule data itself is copied bit for bit.

One 2 x 2 gloo group on the CPU holds the placements: each leaf's local
shard shape is ``local_shape``'s, a spec entry naming two mesh axes lays
the dim out major to minor in mesh order (the reference's order), and
``constrain`` redistributes a DTensor inside ``axis_rules`` and is the
identity elsewhere.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.dist import sharding as ref_shd
from repro.models import transformer as ref_tf
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.dist import sharding as shd
from repro_torch.dist.spawn import run_ranks
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tf
from repro_torch.models.common import tree_leaves

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
GROUP_S = 120


def _abstract(sizes, names):
    return jax.sharding.AbstractMesh(sizes, names)


def test_rule_data_is_the_reference_s():
    assert shd.PRESETS == ref_shd.PRESETS
    assert shd.BASE_RULES == ref_shd.BASE_RULES
    assert shd.DEFAULT_RULES == ref_shd.DEFAULT_RULES
    assert shd._rule_map(None) == ref_shd._rule_map(None)


@pytest.mark.parametrize("arch", ARCH_IDS + ("paper-lm-100m",))
def test_resolve_spec_matches_reference_on_every_preset_and_mesh(arch):
    assert tuple(ARCH_IDS) == tuple(REF_ARCH_IDS)
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    axes = tree_leaves(tf.param_axes(cfg), tf.is_axes)
    shapes = [s.shape for s in tree_leaves(tf.abstract_params(cfg),
                                           tf.is_tensor_spec)]
    ref_axes = jax.tree.leaves(ref_tf.param_axes(rcfg),
                               is_leaf=lambda x: isinstance(x, tuple))
    ref_shapes = [a.shape for a in jax.tree.leaves(
        ref_tf.abstract_params(rcfg))]
    assert axes == [tuple(a) for a in ref_axes]
    assert shapes == [tuple(s) for s in ref_shapes]
    n = 0
    for sizes, names in MESHES.values():
        amesh = _abstract(sizes, names)
        port_mesh = dict(zip(names, sizes))
        for rules in ref_shd.PRESETS.values():
            for shape, ax in zip(shapes, axes):
                want = ref_shd.resolve_spec(shape, ax, amesh, rules)
                got = shd.resolve_spec(shape, ax, port_mesh, rules)
                assert got == tuple(want), (arch, names, shape, ax)
                assert shd.spec_shard_count(got, port_mesh) == \
                    ref_shd.spec_shard_count(want, amesh)
                n += 1
    assert n == len(shapes) * len(MESHES) * len(ref_shd.PRESETS)


def test_granite_vocab_stays_replicated_over_model():
    cfg = get_config("granite-3-8b")
    spec = shd.resolve_spec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                            {"data": 2, "model": 2})
    assert cfg.vocab % 2 == 1 and spec == (None, "data")


def test_placements_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    mesh = {"data": 2, "model": 2}
    assert shd.placements(("model", "data"), mesh) == (Shard(1), Shard(0))
    assert shd.placements((None, "data"), mesh) == (Shard(1), Replicate())
    assert shd.placements((), mesh) == (Replicate(), Replicate())
    pod = {"pod": 2, "data": 16, "model": 16}
    assert shd.placements((("pod", "data"), "model"), pod) == \
        (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        shd.placements((("data", "pod"),), pod)
    assert shd.local_shape((8, 6), (("data", "model"),), mesh) == (2, 6)


def test_constrain_is_the_identity_on_plain_tensors_and_outside():
    x = torch.ones(4, 4)
    assert shd.constrain(x, "batch", "embed") is x
    with shd.axis_rules({"data": 2, "model": 2}):
        assert shd.constrain(x, "batch", "embed") is x
        assert shd.mesh_axis_size("model") == 2
    assert shd.mesh_axis_size("model") == 1


def test_production_mesh_needs_its_world():
    with pytest.raises(ValueError, match="256 ranks"):
        mesh_lib.make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        mesh_lib.make_production_mesh(multi_pod=True)


def _placements_rank(rank, world, init):
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    torch.set_num_threads(1)
    mesh_lib.init_ranks("gloo", rank=rank, world_size=world,
                        init_method=init, device="cpu")
    mesh = mesh_lib.make_local_mesh(2, device="cpu")
    out = {"shape": shd.axis_sizes(mesh)}
    # one dim over both mesh axes: rank (d, m) holds block d * 2 + m
    full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    spec = shd.resolve_spec((8, 3), ("batch", None), mesh,
                            (("batch", ("data", "model")),))
    t = distribute_tensor(full, mesh, list(shd.placements(spec, mesh)))
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    out["two_axes"] = (spec, tuple(t.placements) == (Shard(0), Shard(0)),
                       torch.equal(t.to_local(),
                                   full[(d * 2 + m) * 2:(d * 2 + m + 1) * 2]))
    # every leaf's local shard shape is local_shape's
    cfg = smoke_config("paper-lm-100m")
    axes = tf.param_axes(cfg)
    params = shd.distribute_tree(tf.init_params(cfg, seed=0, device="cpu"),
                                 axes, mesh)
    out["shapes"] = [
        (tuple(p.to_local().shape),
         shd.local_shape(p.shape, shd.resolve_spec(p.shape, a, mesh), mesh))
        for p, a in zip(tree_leaves(params), tree_leaves(axes, tf.is_axes))]
    out["embed"] = tuple(params["embed"].placements)
    # constrain: a redistribute inside the rules, the identity outside
    x = distribute_tensor(torch.ones(4, 8, 16), mesh, list(
        shd.placements(("data",), mesh)))
    with shd.axis_rules(mesh):
        y = shd.constrain(x, "batch", None, "mlp")
    out["constrain"] = (tuple(y.placements), shd.constrain(x, "batch") is x,
                        isinstance(y, DTensor))
    with pytest.raises(ValueError, match="256 ranks"):
        mesh_lib.make_production_mesh(device="cpu")
    return out


def test_placements_on_a_2x2_gloo_mesh(tmp_path):
    from torch.distributed.tensor import Replicate, Shard

    res = run_ranks(_placements_rank, 4, timeout=GROUP_S,
                    tmp_dir=str(tmp_path))
    for r in res:
        assert r["shape"] == {"data": 2, "model": 2}
        assert r["two_axes"] == ((("data", "model"),), True, True)
        assert all(got == want for got, want in r["shapes"]), r["shapes"]
        assert r["embed"] == (Shard(1), Shard(0))      # (vocab, embed)
        assert r["constrain"] == ((Shard(0), Shard(2)), True, True)
    assert any(np.prod(got) < np.prod(full)
               for (got, _), full in zip(res[0]["shapes"], [
                   s.shape for s in tree_leaves(
                       tf.abstract_params(smoke_config("paper-lm-100m")),
                       tf.is_tensor_spec)]))
    assert Replicate() not in res[0]["embed"]
