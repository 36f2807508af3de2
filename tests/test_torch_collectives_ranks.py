"""The two-stage int8 all-reduce across ranks against the JAX package's.

The reference's ``_two_stage_int8_psum`` runs here under
``jax.jit(jax.vmap(..., axis_name="data"))``: ``W`` virtual devices on one
CPU device, the collectives real, the rounding XLA's. The port's runs over
``W`` gloo ranks on the CPU (one spawned group per ``W``, ``W`` in {2,
4}), each rank with its own payload, at lengths that are not a multiple
of ``W * block`` and a 2-D leaf. Outputs and residuals must be equal bit
for bit, through ``_two_stage_int8_psum`` itself, ``compressed_psum``
with ``mesh=`` and ``compressed_psum`` inside ``axis_rules``. The inputs'
scales span e^-3..e^3 and the residuals stay normal (XLA flushes
subnormals, eager torch keeps them; ROADMAP section 3). The one-process
emulation the card is held against equals the reference too, and the
wire meter (``launch.analysis.trace_collectives``) books each rank's
collectives exactly: the exchange's op rows at the full arrays, a
broadcast under its kind, an all-reduce under its op.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import collectives as ref_coll
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.dist.spawn import run_ranks
from repro_torch.launch import analysis
from repro_torch.launch import mesh as mesh_lib

BLOCK = 256
LENGTHS = (3000, 70001)
LEAF = (37, 61)
GROUP_S = 120


def payloads(w: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    scale = np.exp(rng.uniform(-3, 3, (w, 1)))
    return (rng.standard_normal((w, n)) * scale).astype(np.float32)


def reference_two_stage(x: np.ndarray):
    f = jax.jit(jax.vmap(
        lambda v: ref_coll._two_stage_int8_psum(v, "data", BLOCK),
        axis_name="data"))
    out, err = f(jnp.asarray(x))
    return np.asarray(out), np.asarray(err)


def reference_compressed(x: np.ndarray, e: np.ndarray):
    f = jax.jit(jax.vmap(
        lambda v, r: ref_coll.compressed_psum(v, "data", r, block=BLOCK),
        axis_name="data"))
    out, err = f(jnp.asarray(x), jnp.asarray(e))
    return np.asarray(out), np.asarray(err)


def bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("w", [2, 4])
def test_plain_emulation_equals_reference(w):
    for i, n in enumerate(LENGTHS):
        x = payloads(w, n, 10 * w + i)
        want, want_err = reference_two_stage(x)
        got, got_err = coll.two_stage_int8_psum_plain(torch.from_numpy(x),
                                                      BLOCK)
        for r in range(w):
            assert np.array_equal(bits(got.numpy()), bits(want[r]))
        assert np.array_equal(bits(got_err.numpy()), bits(want_err))


def _exchange_rank(rank, world, init):
    torch.set_num_threads(1)
    mesh_lib.init_ranks("gloo", rank=rank, world_size=world,
                        init_method=init, device="cpu")
    mesh = mesh_lib.make_local_mesh(device="cpu")
    group = coll.axis_group("data", mesh)
    out = {"two_stage": [], "wire": []}
    for i, n in enumerate(LENGTHS):
        x = torch.from_numpy(payloads(world, n, 10 * world + i)[rank])
        (o, e), ops, _ = analysis.trace_collectives(
            lambda: coll._two_stage_int8_psum(x, group, BLOCK), replay=False)
        out["two_stage"].append((o.numpy(), e.numpy()))
        out["wire"].append(ops)
    _, ops, kinds = analysis.trace_collectives(lambda: (
        coll.broadcast(torch.full((5,), float(rank)), group),
        coll.all_reduce(torch.ones(3, dtype=torch.float64), group)),
        replay=False)
    out["small"] = (ops, kinds)
    leaf = payloads(world, int(np.prod(LEAF)), 99)[rank].reshape(LEAF)
    err = payloads(world, int(np.prod(LEAF)), 98)[rank].reshape(LEAF) * 1e-3
    o, e = coll.compressed_psum(torch.from_numpy(leaf), "data",
                                torch.from_numpy(err), block=BLOCK,
                                mesh=mesh)
    with shd.axis_rules(mesh):
        o2, e2 = coll.compressed_psum(torch.from_numpy(leaf), "data",
                                      torch.from_numpy(err), block=BLOCK)
    out["compressed"] = (o.numpy(), e.numpy(), o2.numpy(), e2.numpy())
    return out


@pytest.mark.parametrize("w", [2, 4])
def test_two_stage_psum_on_gloo_ranks_equals_reference(w, tmp_path):
    res = run_ranks(_exchange_rank, w, timeout=GROUP_S,
                    tmp_dir=str(tmp_path))
    for i, n in enumerate(LENGTHS):
        want, want_err = reference_two_stage(payloads(w, n, 10 * w + i))
        npad = n + (-n) % (w * BLOCK)
        for r, got in enumerate(res):
            o, e = got["two_stage"][i]
            assert o.shape == (n,) and e.shape == (n,)
            assert np.array_equal(bits(o), bits(want[r])), (w, n, r)
            assert np.array_equal(bits(e), bits(want_err[r])), (w, n, r)
            # int8 chunks and f32 scales, two calls each: the whole
            # payload through the all-to-all, every owned chunk out of
            # the all-gather (the full array, as the HLO count books it)
            ops = got["wire"][i]
            for op in ("all-to-all", "all-gather"):
                assert {k: ops[op][k] for k in
                        ("count", "bytes", "bytes_bf16eq")} == {
                    "count": 2, "bytes": npad + 4 * npad // BLOCK,
                    "bytes_bf16eq": npad + 2 * npad // BLOCK}, (op, ops)
                assert ops[op]["wire_bytes_bf16eq_s8"] == int(
                    analysis._wire_bytes(op, npad, w))
            assert ops["total_bytes"] == 2 * (npad + 4 * npad // BLOCK)
    for got in res:
        ops, kinds = got["small"]
        # 5 f32 from rank 0 to every rank, 3 f64 summed over the ring
        assert kinds["broadcast"]["count"] == 1
        assert kinds["broadcast"]["bytes"] == 20
        assert ops["collective-permute"]["bytes"] == 20
        assert {k: ops["all-reduce"][k] for k in
                ("count", "bytes", "wire_bytes")} == {
            "count": 1, "bytes": 24,
            "wire_bytes": int(analysis._wire_bytes("all-reduce", 24, w))}
        assert set(kinds) == {"broadcast", "implicit"}
    leaf = payloads(w, int(np.prod(LEAF)), 99).reshape((w,) + LEAF)
    err = payloads(w, int(np.prod(LEAF)), 98).reshape((w,) + LEAF) * 1e-3
    want, want_err = reference_compressed(leaf, err)
    for r, got in enumerate(res):
        for o, e in (got["compressed"][:2], got["compressed"][2:]):
            assert np.array_equal(bits(o), bits(want[r]))
            assert np.array_equal(bits(e), bits(want_err[r]))


def test_an_axis_needs_a_mesh():
    with pytest.raises(ValueError, match="names no mesh"):
        coll.compressed_psum(torch.ones(4), "data")
