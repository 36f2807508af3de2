"""Shared modeling primitives: parameter-spec machinery, norms, RoPE,
embeddings, blockwise (memory-efficient) attention, losses.

The port of ``src/repro/models/common.py``. Parameters are plain trees
(dicts and lists) of tensors. Every parameter leaf is declared through a
``Spec`` carrying its shape, dtype and *logical axis names*; the dist
layer maps logical axes onto mesh axes (``dist.sharding``).
Layer stacks are stored with a leading ``layers`` axis, as in the
reference, so a converted tree matches it leaf for leaf.

The math keeps the reference's dtypes: f32 internals where it upcasts,
products in the parameters' dtype elsewhere, and ``einsum`` promotes its
operands to one dtype as ``jnp.einsum`` does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.dist import collectives
from repro_torch.dist.sharding import constrain, is_dtensor

PyTree = Any

DEFAULT_PARAM_DTYPE = torch.bfloat16
COMPUTE_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class Spec:
    """Declaration of one parameter leaf."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names, len == len(shape)
    dtype: Any = None                 # None -> DEFAULT_PARAM_DTYPE
    init: str = "normal"              # "normal" | "zeros" | "ones" | "small"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


# ---------------------------------------------------------------------------
# trees: dicts (keys in sorted order, as jax.tree flattens them) and lists
# ---------------------------------------------------------------------------

def tree_leaves(tree: PyTree, is_leaf: Optional[Callable] = None) -> list:
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    return [tree]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree,
             is_leaf: Optional[Callable] = None) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the trees of the same
    structure in ``rest``; raises if a structure differs."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or sorted(r) != sorted(tree):
                raise ValueError(f"tree structure differs: keys "
                                 f"{sorted(tree)} against {r!r:.200}")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    if isinstance(tree, (list, tuple)):
        for r in rest:
            if not isinstance(r, (list, tuple)) or len(r) != len(tree):
                raise ValueError(f"tree structure differs: a list of "
                                 f"{len(tree)} against {r!r:.200}")
        return type(tree)(tree_map(fn, *xs, is_leaf=is_leaf)
                          for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unflatten(like: PyTree, leaves: list) -> PyTree:
    """``like``'s structure holding ``leaves``, taken in ``tree_leaves``'
    order (dict keys sorted)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def tree_unzip(tree: PyTree, n: int) -> Tuple[PyTree, ...]:
    """A tree whose leaves are ``n``-tuples as ``n`` trees of the same
    structure, the i-th holding each tuple's i-th entry."""
    def is_tuple(x):
        return isinstance(x, tuple) and len(x) == n and \
            not isinstance(x[0], (dict, list, tuple))
    return tuple(tree_map(lambda t: t[i], tree, is_leaf=is_tuple)
                 for i in range(n))


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def resolve_device(device: Union[str, torch.device, None],
                   who: str) -> torch.device:
    """The card unless the caller names another device; there is no
    silent fallback to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to "
                           "run on the host")
    return device


def materialize(spec: Spec, gen: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """One leaf. Draws come from ``gen`` on its device (the host unless
    the caller asks otherwise, so that a seed gives the same values on
    every device); they are not ``jax.random``'s."""
    dtype = spec.dtype or DEFAULT_PARAM_DTYPE
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    # fan-in scaled normal; last axis treated as fan-out
    fan_in = int(np.prod(spec.shape[:-1])) if len(spec.shape) > 1 else spec.shape[0]
    scale = 0.02 if spec.init == "small" else 1.0 / np.sqrt(max(fan_in, 1))
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return x.to(device=device, dtype=dtype)


def tree_init(specs: PyTree, seed: int, device: torch.device,
              draw_on_device: bool = False) -> PyTree:
    gen = torch.Generator(device if draw_on_device else "cpu").manual_seed(seed)
    leaves = tree_leaves(specs, is_spec)
    by_id = {id(s): materialize(s, gen, device) for s in leaves}
    return tree_map(lambda s: by_id[id(s)], specs, is_leaf=is_spec)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A leaf's shape and dtype, no data: the port's stand-in for
    ``jax.ShapeDtypeStruct``."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.dtype.itemsize


def tree_abstract(specs: PyTree) -> PyTree:
    """Each ``Spec`` as the ``TensorSpec`` of the leaf it declares."""
    return tree_map(
        lambda s: TensorSpec(tuple(s.shape), s.dtype or DEFAULT_PARAM_DTYPE),
        specs, is_leaf=is_spec)


def tree_axes(specs: PyTree) -> PyTree:
    """Each ``Spec`` as its tuple of logical axis names."""
    return tree_map(lambda s: s.axes, specs, is_leaf=is_spec)


def stack_layer_specs(layer_specs: PyTree, n_layers: int) -> PyTree:
    """Add a leading ``layers`` axis to every leaf spec."""
    return tree_map(
        lambda s: Spec((n_layers,) + s.shape, ("layers",) + s.axes, s.dtype, s.init),
        layer_specs, is_leaf=is_spec)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

# ``launch.analysis``' hooks, set only during its walks: ``_replay`` runs
# or replays each ``repeated`` body, ``_einsum_observer(eq, operands)`` is
# a context around each ``einsum`` call
_replay: Optional[Callable] = None
_einsum_observer: Optional[Callable] = None


def repeated(fn: Callable) -> Callable:
    """Mark ``fn`` as a loop body the reference runs as a ``scan`` (a
    layer, a tile, a recurrent step, a microbatch). It runs as it is;
    during ``launch.analysis``' walks a further call with the same input
    signature may be replayed from the first one's counts."""
    @functools.wraps(fn)
    def body(*args, **kwargs):
        if _replay is None:
            return fn(*args, **kwargs)
        return _replay(fn, args, kwargs)
    return body


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with ``jnp.einsum``'s dtype promotion: every
    operand is cast to the operands' common dtype first. DTensor operands
    contract shard by shard (:func:`_einsum_on_shards`)."""
    dt = operands[0].dtype
    for t in operands[1:]:
        dt = torch.promote_types(dt, t.dtype)
    operands = tuple(t.to(dt) for t in operands)
    observe = _einsum_observer
    with contextlib.nullcontext() if observe is None else \
            observe(eq, operands):
        if any(is_dtensor(t) for t in operands):
            return _einsum_on_shards(eq, *operands)
        return torch.einsum(eq, *operands)


def _explicit(eq: str, operands) -> Tuple[list, str]:
    """``eq``'s input subscripts and output with each ``...`` spelled out
    in letters the equation does not use."""
    ins, out = eq.replace(" ", "").split("->")
    subs = ins.split(",")
    free = [c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ" if c not in eq]
    n = max((t.ndim - len(s) + 3 for t, s in zip(operands, subs)
             if "..." in s), default=0)
    fill = "".join(free[:n])
    subs = [s.replace("...", fill[n - (t.ndim - len(s) + 3):])
            for t, s in zip(operands, subs)]
    return subs, out.replace("...", fill)


def _einsum_on_shards(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """An einsum of DTensors computed shard by shard: on each mesh dim the
    largest operand sharded there names the subscript split over it;
    every operand holding that subscript is laid out split the same way,
    the others whole; each rank contracts its shards, and the result is
    split where its subscripts are and summed over the ranks that split a
    contracted subscript: DTensor's own plan for a contraction, without
    its views of permuted shards (which torch 2.11 refuses when a shard is
    not contiguous, or when it would flatten a split dim; on a production
    mesh DTensor's own plan also splits a head dim, 12 or 8 heads, over
    16 ranks and then cannot unflatten it), and with the sum made at once
    (torch 2.11 cannot add a pending sum to a shard). Gradients flow
    through it: an operand whole on a mesh dim where the others are split
    gets its gradient there as a pending sum, which the redistribution's
    backward reduces."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    subs, out = _explicit(eq, operands)
    like = next(t for t in operands if is_dtensor(t))
    by_size = sorted(zip(operands, subs), key=lambda ts: -ts[0].numel())
    split = []
    for m in range(like.device_mesh.ndim):
        name = None
        for t, sub in by_size:
            p = t.placements[m] if is_dtensor(t) else Replicate()
            if p.is_shard():
                name = sub[p.dim % t.ndim]
                break
        split.append(name)
    local = []
    for t, sub in zip(operands, subs):
        place = tuple(Shard(sub.index(n)) if n is not None and n in sub
                      else Replicate() for n in split)
        # an operand held whole on a mesh dim whose ranks each contract
        # their own shard of another gets a pending sum as its gradient
        grad = tuple(Partial() if n is not None and n not in sub else p
                     for n, p in zip(split, place))
        t = collectives.redistribute("reshard",
                                     collectives.as_dtensor(t, like), place)
        local.append(t.to_local(grad_placements=grad))
    res = torch.einsum(",".join(subs) + "->" + out, *local).contiguous()
    place = tuple(Replicate() if n is None else Shard(out.index(n))
                  if n in out else Partial() for n in split)
    res = collectives.from_local(res, like, place)
    return collectives.redistribute("reshard", res, collectives.without_dims(
        place, (), res.ndim))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (D/2,)
    ang = positions.float()[..., None] * freqs              # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    # x (bf16) times the f32 angles promotes to f32, then casts back once
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    hid_axes = (None,) * (x.ndim - 1) + ("mlp",)
    hid_axes = ("batch",) + hid_axes[1:]
    g = constrain(einsum("...d,df->...f", x, w_gate), *hid_axes)
    u = constrain(einsum("...d,df->...f", x, w_up), *hid_axes)
    return einsum("...f,fd->...d", F.silu(g) * u, w_down)


# ---------------------------------------------------------------------------
# attention (plain torch): blockwise online-softmax, never materializes S x S
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _attn_block(q, k, v, q_pos, k_pos, causal, window, scale):
    """One (q-block, kv-block) tile. q:(B,bq,H,D) k/v:(B,bk,Hkv,D)."""
    b, bq, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    qg = q.reshape(b, bq, hkv, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    mask = torch.ones((bq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    mask &= (k_pos >= 0)[None, :]
    # NEG_INF, not -inf: a wholly masked tile gets m = NEG_INF and l = bk,
    # which the next live tile's rescale multiplies by exp(NEG_INF - m) = 0
    s = torch.where(mask[None, None, None], s, NEG_INF)
    m = torch.amax(s, dim=-1)                                 # (B,hkv,g,bq)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return m, l, o


@repeated
def _online_tile(m_run, l_run, o_run, q, k, v, q_pos, k_pos, causal, window,
                 scale):
    """One kv tile folded into a q tile's running max, sum and output."""
    m, l, o = _attn_block(q, k, v, q_pos, k_pos, causal, window, scale)
    m_new = torch.maximum(m_run, m)
    a_old = torch.exp(m_run - m_new)
    a_new = torch.exp(m - m_new)
    l_run = l_run * a_old + l * a_new
    o_run = o_run * a_old[..., None] + o * a_new[..., None]
    return m_new, l_run, o_run


def _attention_on_shards(q, k, v, **kw):
    """``blockwise_attention`` of DTensors, shard by shard: attention
    mixes positions and head features but never rows or heads, so each
    rank runs it on its own batch rows and heads (``local_map``), as XLA's
    SPMD partitioner does. The sequence and feature dims are gathered
    first if sharded; the shards' layout is ``q``'s."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    place = tuple(p if isinstance(p, Shard) and p.dim in (0, 2)
                  else Replicate() for p in q.placements)
    fn = local_map(functools.partial(blockwise_attention, **kw),
                   out_placements=(place,), in_placements=(place,) * 3,
                   device_mesh=q.device_mesh, redistribute_inputs=True)
    return fn(q, k, v)


def blockwise_attention(q, k, v, *, causal=True, window=0,
                        q_offset=0, k_positions=None,
                        block_q=1024, block_k=1024):
    """Memory-efficient attention.

    q: (B, Sq, H, D); k,v: (B, Sk, Hkv, D). Returns (B, Sq, H, D).
    ``q_offset``: absolute position of q[0] (for decode/prefill continuation).
    ``k_positions``: optional (Sk,) absolute positions of cache slots
      (ring buffers); -1 marks invalid slots. Defaults to arange(Sk).

    Every (q tile, kv tile) pair is computed, masked or not, in the
    reference's order: the online softmax over kv tiles inside each q
    tile, f32 scores, ``NEG_INF`` for masked entries.

    A length longer than its block and not a multiple of it, which the
    reference refuses (an ``assert``), pads its last tile: padded keys
    carry position -1, so the mask sends them to ``NEG_INF`` and they add
    exactly 0, and padded query rows are dropped. A length the reference
    serves is tiled as the reference tiles it.

    DTensor inputs run shard by shard (:func:`_attention_on_shards`).
    """
    if is_dtensor(q):
        return _attention_on_shards(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            k_positions=k_positions, block_q=block_q, block_k=block_k)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / np.sqrt(d)
    bq = min(block_q, sq)
    bk = min(block_k, sk)
    dev = q.device
    if k_positions is None:
        k_positions = torch.arange(sk, dtype=torch.int32, device=dev)
    pad_q, pad_k = (-sq) % bq, (-sk) % bk
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        k_positions = torch.cat([k_positions, torch.full(
            (pad_k,), -1, dtype=k_positions.dtype, device=dev)])
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    nq, nk = (sq + pad_q) // bq, (sk + pad_k) // bk
    q_pos = q_offset + torch.arange(sq + pad_q, dtype=torch.int32, device=dev)

    dv = v.shape[-1]
    group = h // hkv
    run_axes = ("batch", "kv_heads", None, None)

    @repeated
    def q_step(qblk, qp):
        m_run = constrain(torch.full((b, hkv, group, bq), NEG_INF,
                                     dtype=torch.float32, device=dev), *run_axes)
        l_run = constrain(torch.zeros((b, hkv, group, bq), dtype=torch.float32,
                                      device=dev), *run_axes)
        o_run = constrain(torch.zeros((b, hkv, group, bq, dv),
                                      dtype=torch.float32, device=dev),
                          *run_axes, None)
        for ki in range(nk):
            sl = slice(ki * bk, (ki + 1) * bk)
            m_run, l_run, o_run = _online_tile(
                m_run, l_run, o_run, qblk, k[:, sl], v[:, sl], qp,
                k_positions[sl], causal, window, scale)
        out = o_run / torch.clamp_min(l_run[..., None], 1e-30)
        out = out.permute(0, 3, 1, 2, 4).reshape(b, bq, h, dv)
        return constrain(out.to(q.dtype), "batch", None, "heads", None)

    tiles = [q_step(q[:, qi * bq:(qi + 1) * bq], q_pos[qi * bq:(qi + 1) * bq])
             for qi in range(nq)]
    if nq == 1:
        return tiles[0][:, :sq]
    return torch.cat(tiles, dim=1)[:, :sq]


def as_positions(pos, device) -> torch.Tensor:
    """A scalar or per-row ``(B,)`` position as an int32 tensor."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(pos, np.int32), device=device)


def _decode_on_shards(q, k, v, k_positions, pos, k_scale, v_scale):
    """``decode_attention`` of DTensors, shard by shard: each rank runs it
    on its own batch rows with every head and cache slot (the caches
    arrive gathered to that layout), as XLA's partitioner does; a per-row
    position or slot map is cut to the same rows. The output's rows are
    laid out as ``q``'s."""
    from torch.distributed.tensor import Replicate

    place = tuple(p if p.is_shard() and p.dim == 0 else Replicate()
                  for p in q.placements)
    q = collectives.redistribute("reshard", q, place)
    lo = collectives.local_offsets(q)[0]
    rows = slice(lo, lo + q.to_local().shape[0])

    def local(t):
        if t is None:
            return None
        return collectives.redistribute(
            "reshard", collectives.as_dtensor(t, q), place).to_local()

    kp = as_positions(k_positions.full_tensor() if is_dtensor(k_positions)
                      else k_positions, q.device)
    kp = kp[rows] if kp.ndim == 2 else kp
    p = as_positions(pos.full_tensor() if is_dtensor(pos) else pos, q.device)
    p = p[rows] if p.ndim == 1 else p
    out = decode_attention(q.to_local(), local(k), local(v), kp, p,
                           local(k_scale), local(v_scale))
    return collectives.from_local(out, q)


def decode_attention(q, k_cache, v_cache, k_positions, pos,
                     k_scale=None, v_scale=None):
    """Single-token attention against a cache. q:(B,1,H,D), caches (B,S,Hkv,D).

    ``k_positions``: (S,) or per-row (B,S) absolute slot positions (-1
    invalid); ``pos``: scalar or per-row (B,) current position. Per-row
    forms are the continuous-batching case: every request sits at its own
    position and padded or stale slots are masked row-wise.

    ``k_scale``/``v_scale`` (B,S,Hkv,nb) mark an int8-resident cache,
    dequantized here per block; an f8-resident cache arrives without
    scales and is upcast here. The scores and the weighted sum are f32
    einsums, as in the reference.
    """
    if is_dtensor(q):
        return _decode_on_shards(q, k_cache, v_cache, k_positions, pos,
                                 k_scale, v_scale)
    if k_scale is not None:
        k_cache = collectives.dequantize_int8_lastdim(k_cache, k_scale)
        v_cache = collectives.dequantize_int8_lastdim(v_cache, v_scale)
    elif k_cache.dtype == collectives.F8_DTYPE:
        k_cache = collectives.uncast_f8(k_cache)
        v_cache = collectives.uncast_f8(v_cache)
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    dv = v_cache.shape[-1]
    group = h // hkv
    scale = 1.0 / np.sqrt(d)
    qg = q.reshape(b, hkv, group, d).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    pos_b = as_positions(pos, q.device).expand(b)
    kp = as_positions(k_positions, q.device)
    if kp.ndim == 1:
        kp = kp[None, :]
    valid = (kp >= 0) & (kp <= pos_b[:, None])          # (B or 1, S) -> (B,S)
    valid = valid.expand(b, k_cache.shape[1])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    s = constrain(s, "batch", "kv_heads", None, "kv_seq")
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return o.reshape(b, 1, h, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy over (optionally masked) positions. fp32 internals."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        # vocab-parallel gold logit: a masked sum, local to each vocab
        # shard (exact: one term is the logit, the others add 0)
        hit = torch.arange(logits.shape[-1], device=logits.device) \
            == labels[..., None].long()
        gold = torch.where(hit, logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
