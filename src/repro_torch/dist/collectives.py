"""Blockwise-int8 gradient compression with error feedback, the
two-stage int8 all-reduce across ranks, and the serve-time collectives.

The port of ``src/repro/dist/collectives.py``. The train step's
``grad_transport="int8_ef"`` quantizes each gradient leaf to symmetric
int8 per ``block`` elements and carries the quantization residual into the
next step (:func:`compressed_psum`). With ``axis_name=None`` there is no
reduction: the quantization error and the residual carry are real, only
the wire is not. With an axis, the reduction is the reference's two-stage
exchange (:func:`_two_stage_int8_psum`) over that mesh dim's process
group: int8 chunks and f32 scales through ``all_to_all_single``, a local
sum, then the requantized owned chunk through ``all_gather_into_tensor``.

The reference always runs jitted, and XLA on the CPU rounds some steps
differently from eager torch: it turns ``amax / 127.0`` into a product
with the f32 reciprocal, it fuses each residual ``carry - q * s`` into
one rounding, and it fuses the peers' dequantize-and-sum into one
rounding per added term. The port takes all three, so its outputs and
residuals equal the jitted reference's bit for bit.

Every collective this module calls goes through :func:`_collective`,
which counts the bytes handed to it by kind (:func:`wire_bytes`): the
port's counterpart of the reference's HLO collective byte count. Over
gloo on the card, the functional all-gather that DTensor calls, which
segfaults there, is staged through pinned host buffers
(:func:`stage_gloo_functional`), decided by the backend before any
collective runs.

The serve half (``collectives.py:145-417`` of the reference) carries the
activation transport and the KV storage scopes, the lastdim and seq-axis
int8 quantizers, the scale-free f8 cast, and the slot admission
primitives. On one device every reshard is the identity, but the int8
round trips stay: ``act_gather`` under ``act_transport="int8"`` changes
the values, as the reference's does on a (1, 1) mesh. Training runs
outside every serve scope, where ``act_gather`` is the identity.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist import sharding

# XLA's rewrite of ``/ 127.0``: a product with the reciprocal in f32
_INV_127 = float(np.float32(1.0 / 127.0))


# ---------------------------------------------------------------------------
# the wire: every collective of this module, counted by kind
# ---------------------------------------------------------------------------

# bytes this process handed to each kind of collective since the last reset
_WIRE: Dict[str, int] = collections.Counter()
# the same bytes in bf16 equivalents (f32 payloads halved), and the s8 part
_WIRE_EQ: Dict[str, int] = collections.Counter()
_WIRE_S8: Dict[str, int] = collections.Counter()

# The functional collectives (the ops DTensor calls) that crash over gloo
# on CUDA tensors: on the card's torch 2.11 ``funcol.all_gather_tensor``
# segfaults in its wait, while the functional all-reduce, reduce-scatter
# and all-to-all and every plain c10d collective run (PERF.md). Under gloo
# on the card these go through pinned host buffers instead
# (:func:`stage_gloo_functional`).
GLOO_HOST_STAGED = ("all_gather_into_tensor",)

# the op library holding the staged kernels, kept for the process's life
_staging: list = []


def reset_wire_bytes() -> None:
    _WIRE.clear()
    _WIRE_EQ.clear()
    _WIRE_S8.clear()


def wire_bytes() -> Dict[str, int]:
    """Bytes handed to each kind of collective since the last reset."""
    return dict(_WIRE)


def wire_detail() -> Dict[str, Dict[str, int]]:
    """Per kind: ``bytes`` (as :func:`wire_bytes`), ``bytes_bf16eq`` (f32
    payloads counted at half their bytes, as the reference's HLO byte
    count prices them) and ``bytes_s8`` (the int8 part)."""
    return {k: {"bytes": _WIRE[k], "bytes_bf16eq": _WIRE_EQ[k],
                "bytes_s8": _WIRE_S8[k]} for k in _WIRE}


def _count(kind: str, t: torch.Tensor) -> None:
    n = t.numel() * t.element_size()
    _WIRE[kind] += n
    _WIRE_EQ[kind] += n // 2 if t.dtype == torch.float32 else n
    if t.dtype == torch.int8:
        _WIRE_S8[kind] += n


def _call(kind: str, out: torch.Tensor, inp: torch.Tensor, group,
          src: Optional[int] = None) -> None:
    if kind == "all_reduce":
        dist.all_reduce(out, group=group)
    elif kind == "broadcast":       # from src, by default the group's rank 0
        if src is None:
            src = 0 if group is None else dist.get_global_rank(group, 0)
        dist.broadcast(out, src, group=group)
    elif kind == "all_to_all_single":
        dist.all_to_all_single(out, inp, group=group)
    elif kind == "all_gather_into_tensor":
        dist.all_gather_into_tensor(out, inp, group=group)
    else:
        raise ValueError(f"unknown collective {kind!r}")


def _collective(kind: str, out: torch.Tensor, inp: torch.Tensor,
                group) -> None:
    """One collective, its input's bytes counted under ``kind``. For
    ``all_reduce`` and ``broadcast`` ``out`` is ``inp``, in place."""
    _count(kind, inp)
    _call(kind, out, inp, group)


def _gloo_host_staged(kind: str, out: torch.Tensor, inp: torch.Tensor,
                      group) -> None:
    """``kind`` on CUDA tensors over gloo, through pinned host copies:
    the input copied down, the collective run on the host, the result
    copied back into ``out``."""
    h_in = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True)
    h_in.copy_(inp)
    h_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    _call(kind, h_out, h_in, group)
    out.copy_(h_out)


def stage_gloo_functional() -> Tuple[str, ...]:
    """Route the functional collectives of :data:`GLOO_HOST_STAGED` on
    CUDA tensors through :func:`_gloo_host_staged`, for this process;
    returns their names. ``launch.mesh.init_ranks`` calls it when it joins
    a gloo group on the card, before any collective."""
    if _staging:
        return GLOO_HOST_STAGED
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_gather_into_tensor(inp, group_size, group_name):
        out = inp.new_empty((inp.shape[0] * group_size,)
                            + tuple(inp.shape[1:]))
        _gloo_host_staged("all_gather_into_tensor", out, inp.contiguous(),
                          _resolve_process_group(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather_into_tensor, "CUDA")
    _staging.append(lib)
    return GLOO_HOST_STAGED


def ranked() -> bool:
    """Whether this process is one rank of several."""
    return dist.is_initialized() and dist.get_world_size() > 1


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, in place (counted)."""
    _collective("all_reduce", x, x, group)
    return x


def broadcast(x: torch.Tensor, group=None, src: Optional[int] = None
              ) -> torch.Tensor:
    """``x`` from global rank ``src`` (by default the group's rank 0) to
    every rank of the group, in place (counted). A host tensor crosses an
    NCCL group through the card."""
    if x.device.type == "cpu" and dist.get_backend(group) == "nccl":
        on_card = x.to(torch.device("cuda", torch.cuda.current_device()))
        _count("broadcast", on_card)
        _call("broadcast", on_card, on_card, group, src)
        x.copy_(on_card)
    else:
        _count("broadcast", x)
        _call("broadcast", x, x, group, src)
    return x


def axis_group(axis_name: str, mesh=None):
    """The process group of mesh dim ``axis_name`` of ``mesh``, or of the
    active :func:`sharding.axis_rules` mesh; ``None`` on the one-process
    ``LocalMesh`` (a world of one)."""
    mesh = sharding.current_mesh() if mesh is None else mesh
    if mesh is None:
        raise ValueError(f"axis {axis_name!r} names no mesh: pass mesh= or "
                         "run inside sharding.axis_rules(mesh)")
    if not sharding.is_device_mesh(mesh):        # LocalMesh: one process
        if mesh.shape.get(axis_name, 1) != 1:
            raise ValueError(f"a one-process mesh has no axis "
                             f"{axis_name!r} of size > 1")
        return None
    return mesh.get_group(axis_name)


def exchange(kind: str, sends, recvs) -> list:
    """Point-to-point transfers between ranks of the world group, all in
    flight together: ``sends`` is a list of ``(tensor, dst)``, ``recvs``
    a list of ``(shape, dtype, device, src)``; returns the received
    tensors in ``recvs``' order. The bytes sent are counted under
    ``kind``. Over gloo a card's tensor crosses through a host copy (gloo
    moves host memory)."""
    host = dist.get_backend() == "gloo"
    ops, back = [], []
    for t, dst in sends:
        _count(kind, t)
        t = t.contiguous()
        if host and t.device.type != "cpu":
            t = t.cpu()
        ops.append(dist.P2POp(dist.isend, t.view(torch.uint8)
                              if t.dtype == F8_DTYPE else t, dst))
    for shape, dtype, device, src in recvs:
        dev = torch.device("cpu") if host else torch.device(device)
        buf = torch.empty(shape, dtype=torch.uint8 if dtype == F8_DTYPE
                          else dtype, device=dev)
        ops.append(dist.P2POp(dist.irecv, buf, src))
        back.append((buf, dtype, device))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return [buf.view(dtype).to(device) for buf, dtype, device in back]


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block int8 quantization.

    Flattens ``x``, zero-pads to a multiple of ``block``, and scales each
    block by its abs-max so values land in [-127, 127]. Returns
    ``(q, scales)`` with ``q: int8 (n_blocks, block)`` and
    ``scales: float32 (n_blocks,)``.
    """
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return _quantize_blocks(flat.reshape(-1, block))


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`; returns the first ``n`` elements."""
    return _dequantize_blocks(q, scales).reshape(-1)[:n]


def _quantize_blocks(blocks: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the trailing ``block`` axis of ``(..., block)``."""
    scales = blocks.abs().amax(dim=-1) * _INV_127
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    # torch.round, like jnp.round, rounds halves to even
    q = torch.clamp(torch.round(blocks / safe[..., None]), -127, 127)
    return q.to(torch.int8), scales


def _dequantize_blocks(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return q.float() * scales[..., None]


def _dequant_sum(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``sum_j q[j] * scales[j]`` over the leading axis of ``(w, nb,
    block)``, each product added to the running f32 sum with one rounding,
    as XLA's fused dequantize-and-reduce does: the product is exact in
    f64 (8 by 24 bits), the sum rounds once to f32."""
    acc = torch.zeros(q.shape[1:], dtype=torch.float32, device=q.device)
    for j in range(q.shape[0]):
        acc = (acc.double() + q[j].double()
               * scales[j].double()[..., None]).float()
    return acc


def _residual(carry: torch.Tensor, q: torch.Tensor, scales: torch.Tensor
              ) -> torch.Tensor:
    """``carry - q * scales`` blockwise with one rounding, as XLA's fused
    multiply-subtract: ``q * s`` is exact in f64 and so is the
    difference, which then rounds once. ``carry`` is ``(..., block)``."""
    exact = q.double() * scales.double()[..., None]
    return (carry.double() - exact).float()


def _two_stage_int8_psum(flat: torch.Tensor, group, block: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-reduce the f32 vector ``flat`` across ``group`` moving int8.

    The reference's two-stage exchange: the payload padded to a multiple
    of ``w * block`` and split into one chunk per peer, each chunk
    quantized blockwise; the int8 chunks and f32 scales through
    ``all_to_all_single``, so each rank receives every peer's
    contribution to its own chunk; dequantize and sum in peer order;
    requantize the owned chunk and ``all_gather_into_tensor`` the int8
    chunks and scales. Stage 1's error covers the whole local payload,
    stage 2's only the owned chunk. ``group=None`` is a world of one.

    Returns ``(summed_flat, residual_flat)`` of ``flat``'s length.
    """
    w = 1 if group is None else dist.get_world_size(group)
    r = 0 if group is None else dist.get_rank(group)
    n = flat.shape[0]
    pad = (-n) % (w * block)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    npad = flat.shape[0]
    chunk = npad // w
    blocks = flat.reshape(w, chunk // block, block)
    # stage 1: my contribution to every peer's chunk, int8 on the wire
    q1, s1 = _quantize_blocks(blocks)
    err1 = _residual(blocks, q1, s1).reshape(npad)
    q1x, s1x = torch.empty_like(q1), torch.empty_like(s1)
    if group is None:
        q1x.copy_(q1)
        s1x.copy_(s1)
    else:
        _collective("all_to_all_single", q1x, q1, group)
        _collective("all_to_all_single", s1x, s1, group)
    mine = _dequant_sum(q1x, s1x)                # (chunk // block, block)
    # stage 2: broadcast the reduced chunk, int8 on the wire again
    q2, s2 = _quantize_blocks(mine)
    err2 = _residual(mine, q2, s2).reshape(chunk)
    # gathered along the leading axis: rank j's chunk at rows j * nb...
    q2g = q2.new_empty((w * q2.shape[0], block))
    s2g = s2.new_empty((w * s2.shape[0],))
    if group is None:
        q2g.copy_(q2)
        s2g.copy_(s2)
    else:
        _collective("all_gather_into_tensor", q2g, q2, group)
        _collective("all_gather_into_tensor", s2g, s2, group)
    out = _dequantize_blocks(q2g, s2g).reshape(npad)
    new_err = err1.clone()
    new_err[r * chunk:(r + 1) * chunk] += err2
    return out[:n], new_err[:n]


def two_stage_int8_psum_plain(stack: torch.Tensor, block: int = 256
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-stage exchange of ``stack`` (``(w, n)`` f32, row ``r`` rank
    ``r``'s payload) in one process, no wire: every rank's stage 1, the
    all-to-all as a transpose, every rank's stage 2. Returns ``(out,
    residuals)``: the summed ``(n,)`` vector every rank holds, and
    ``(w, n)`` per-rank residuals. The plain version the ranks' exchange
    is held against."""
    w, n = stack.shape
    pad = (-n) % (w * block)
    flat = torch.nn.functional.pad(stack.float(), (0, pad))
    npad = flat.shape[1]
    chunk = npad // w
    blocks = flat.reshape(w, w, chunk // block, block)   # [src, dst, ...]
    q1, s1 = _quantize_blocks(blocks)
    err1 = _residual(blocks, q1, s1).reshape(w, npad)
    outs, errs = [], []
    for d in range(w):
        mine = _dequant_sum(q1[:, d], s1[:, d])
        q2, s2 = _quantize_blocks(mine)
        outs.append(_dequantize_blocks(q2, s2).reshape(chunk))
        e = err1[d].clone()
        e[d * chunk:(d + 1) * chunk] += _residual(mine, q2, s2).reshape(chunk)
        errs.append(e[:n])
    return torch.cat(outs)[:n], torch.stack(errs)


def compressed_psum(x: torch.Tensor, axis_name: Optional[str] = None,
                    err: Optional[torch.Tensor] = None, *, block: int = 256,
                    mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """psum of an int8-compressed payload with error-feedback accumulation.

    The carried residual ``err`` (same shape as ``x``, float32; zeros or
    ``None`` on the first step) is added before quantization, and the new
    residual ``(x + err) - dequantized`` is returned for the next step.
    ``axis_name=None`` is the single-device form: the quantization error
    and the residual carry are real, only the wire is not. With an
    ``axis_name`` the reduction is the two-stage int8 exchange over that
    dim of ``mesh``, or of the active ``axis_rules`` mesh.

    Returns ``(summed, new_err)``: ``summed`` in ``x``'s dtype, ``new_err``
    in float32.
    """
    xf = x.float()
    carry = xf if err is None else xf + err.float()
    if axis_name is not None:
        out, new_err = _two_stage_int8_psum(
            carry.reshape(-1), axis_group(axis_name, mesh), block)
        return (out.reshape(carry.shape).to(x.dtype),
                new_err.reshape(carry.shape))
    q, scales = quantize_int8(carry, block)
    n = carry.numel()
    deq = dequantize_int8(q, scales, n).reshape(carry.shape)
    # one rounding, as XLA's fused multiply-subtract: q * s is exact in
    # f64 (8 by 24 bits) and so is the difference, which then rounds once
    exact = q.double() * scales.double()[:, None]
    new_err = (carry.double() - exact.reshape(-1)[:n].reshape(carry.shape))
    return deq.to(x.dtype), new_err.float()


# ---------------------------------------------------------------------------
# reshards on a DeviceMesh, counted; local shards and their offsets
# ---------------------------------------------------------------------------

def _moves_data(old, new) -> bool:
    """Whether going from placements ``old`` to ``new`` hands data to
    another rank: every change from a shard or a pending sum does, a
    replicated dim becoming a shard is a local slice."""
    return any(a != b and not a.is_replicate() for a, b in zip(old, new))


# the kinds of the redistributions in progress, innermost last: what
# ``launch.analysis.CollectiveMode`` books DTensor's collectives under
_KINDS: list = []


def current_kind() -> Optional[str]:
    """The kind of the redistribution in progress, or ``None``."""
    return _KINDS[-1] if _KINDS else None


def redistribute(kind: str, x, place):
    """DTensor ``x`` laid out by ``place``; the local bytes it hands over,
    if any, counted under ``kind``."""
    place = tuple(place)
    if tuple(x.placements) == place:
        return x
    if _moves_data(x.placements, place):
        _count(kind, x.to_local())
    _KINDS.append(kind)
    try:
        return x.redistribute(x.device_mesh, place)
    finally:
        _KINDS.pop()


def target_placements(shape, logical_axes):
    """The placements the active ``axis_rules`` context resolves for an
    array of ``shape`` with ``logical_axes``."""
    mesh, rules = sharding.current_context()
    return sharding.placements(
        sharding.resolve_spec(tuple(shape), tuple(logical_axes), mesh, rules),
        mesh)


def reshard(kind: str, x, *logical_axes: Optional[str]):
    """``constrain`` with its wire counted under ``kind``: a DTensor inside
    a context redistributed to its logical axes' layout; anything else
    unchanged."""
    if sharding.current_context() is None or not sharding.is_dtensor(x):
        return x
    return redistribute(kind, x, target_placements(x.shape, logical_axes))


def without_dims(place, dims, ndim: int) -> tuple:
    """``place`` with every shard of a tensor dim in ``dims`` (and every
    pending sum) replaced by ``Replicate``."""
    from torch.distributed.tensor import Replicate

    dims = {d % ndim for d in dims}
    return tuple(Replicate() if p.is_partial()
                 or (p.is_shard() and p.dim % ndim in dims) else p
                 for p in place)


def local_offsets(x) -> Tuple[int, ...]:
    """Global index of the first element of this rank's shard of DTensor
    ``x``, per dim (shards of one dim nest major to minor in mesh-dim
    order, as DTensor lays them out; every shard is even)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    off = [0] * x.ndim
    size = list(x.shape)
    for m, p in enumerate(x.placements):
        if p.is_shard():
            d = p.dim % x.ndim
            size[d] //= mesh.size(m)
            off[d] += coord[m] * size[d]
    return tuple(off)


def from_local(local: torch.Tensor, like=None, place=None, shape=None,
               mesh=None):
    """``local`` as the shard of a DTensor on ``like``'s mesh (or
    ``mesh``), laid out by ``place`` (``like``'s placements by
    default)."""
    from torch.distributed.tensor import DTensor

    mesh = like.device_mesh if mesh is None else mesh
    place = tuple(like.placements if place is None else place)
    if shape is None:
        shape = list(local.shape)
        for m, p in enumerate(place):
            if p.is_shard():
                shape[p.dim % local.ndim] *= mesh.size(m)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(local, mesh, place,
                              shape=torch.Size(shape), stride=tuple(stride))


def as_dtensor(x, like):
    """A plain tensor as a DTensor replicated on ``like``'s mesh (every
    rank holds the same values); a DTensor as it is."""
    if sharding.is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim)


def on_local(fn, x, dims, *others, kind: str = "reshard"):
    """``fn`` applied to this rank's shards with the dims in ``dims``
    whole: DTensor ``x`` gathered along them first (counted under
    ``kind``), each DTensor of ``others`` laid out as ``x`` then is, plain
    ones passed as they are; the result laid out as ``x``'s shard was.
    ``fn`` may change the sizes of ``dims`` only. Without a DTensor ``x``
    every operand goes through ``fn`` as it is."""
    if not sharding.is_dtensor(x):
        return fn(x, *others)
    x = redistribute(kind, x, without_dims(x.placements, dims, x.ndim))
    rest = [redistribute(kind, o, x.placements).to_local()
            if sharding.is_dtensor(o) else o for o in others]
    return from_local(fn(x.to_local(), *rest), x)


# ---------------------------------------------------------------------------
# serve activation transport: quantized all-gathers, no error feedback
# ---------------------------------------------------------------------------

ACT_TRANSPORTS = ("bf16", "int8")
ACT_BLOCK = 256

# the prefill->decode cache handoff's wire format, and the decode-resident
# cache's storage dtype: orthogonal axes
CACHE_TRANSFERS = ("bf16", "int8")
KV_STORAGES = ("bf16", "int8", "f8")

# f8 (e4m3) resident-cache storage: scale-free, exactly half the bf16
# bytes. e4m3fn has no inf (overflow becomes nan), so the cast clips to
# the finite range first.
F8_DTYPE = torch.float8_e4m3fn
F8_MAX = 448.0


def cast_f8(x: torch.Tensor) -> torch.Tensor:
    """Clip to the f8 finite range and cast to e4m3; every element rounds
    on its own. The same byte as the reference's jitted cast for each of
    the 65,536 bf16 bit patterns, NaNs included."""
    return torch.clamp(x.float(), -F8_MAX, F8_MAX).to(F8_DTYPE)


def uncast_f8(q: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`cast_f8` (exact: every f8 value is an f32 and a
    bf16 value)."""
    return q.to(dtype)


def lastdim_blocks(d: int, block: int = ACT_BLOCK) -> Tuple[int, int]:
    """(block_size, n_blocks) the lastdim quantizer uses for a trailing dim
    of ``d``: ``block`` when it divides ``d``, else one block spanning the
    whole dim."""
    b = block if d % block == 0 else d
    return b, d // b


def quantize_int8_lastdim(x: torch.Tensor, block: int = ACT_BLOCK
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization blocked along the trailing axis only,
    so blocks never cross a row. Returns ``(q, scales)`` with ``q: int8``
    of ``x.shape`` and ``scales: float32`` of ``x.shape[:-1] +
    (n_blocks,)``."""
    d = x.shape[-1]
    b, nb = lastdim_blocks(d, block)
    blocks = x.float().reshape(tuple(x.shape[:-1]) + (nb, b))
    q, scales = _quantize_blocks(blocks)
    return q.reshape(x.shape), scales


def dequantize_int8_lastdim(q: torch.Tensor, scales: torch.Tensor
                            ) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_lastdim` (float32 out)."""
    nb = scales.shape[-1]
    d = q.shape[-1]
    blocks = q.reshape(tuple(q.shape[:-1]) + (nb, d // nb))
    return _dequantize_blocks(blocks, scales).reshape(q.shape)


# ---------------------------------------------------------------------------
# the prefill->decode cache stream and the slot admission primitives
# ---------------------------------------------------------------------------

def quantize_int8_seqaxis(x: torch.Tensor, seq_axis: int,
                          block: int = ACT_BLOCK
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise int8 along the sequence axis of a cache leaf: the leaf
    viewed with that axis trailing, then :func:`quantize_int8_lastdim`.
    Returns ``(q, scales)`` in the seq-last layout."""
    return quantize_int8_lastdim(torch.movedim(x, seq_axis, -1), block)


def dequantize_int8_seqaxis(q: torch.Tensor, scales: torch.Tensor,
                            seq_axis: int) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_seqaxis` (float32 out, the sequence
    axis back in its place)."""
    return torch.movedim(dequantize_int8_lastdim(q, scales), -1, seq_axis)


def update_slice(buf: torch.Tensor, upd: torch.Tensor, starts) -> torch.Tensor:
    """``jax.lax.dynamic_update_slice`` as a new tensor: ``upd`` written
    into a copy of ``buf`` at ``starts``, each start clamped to
    ``[0, buf.shape[i] - upd.shape[i]]`` as XLA clamps it (a negative
    start counting from the end first, as JAX reads it), so an update
    always lands whole.

    A DTensor ``buf`` keeps its layout: each rank writes the part of the
    update that falls in its own shard, read from ``upd`` laid out
    whole."""
    lo = []
    for i, s in enumerate(starts):
        s = int(s) + (buf.shape[i] if int(s) < 0 else 0)
        lo.append(min(max(s, 0), buf.shape[i] - upd.shape[i]))
    if not sharding.is_dtensor(buf):
        out = buf.clone()
        out[tuple(slice(s, s + n) for s, n in zip(lo, upd.shape))] = \
            upd.to(buf.dtype)
        return out
    if sharding.is_dtensor(upd):
        upd = redistribute("reshard", upd, without_dims(
            upd.placements, range(upd.ndim), upd.ndim))
        upd = upd.to_local()
    local = buf.to_local()
    out = local.clone()
    dst, src = [], []
    for s, n, o, m in zip(lo, upd.shape, local_offsets(buf), local.shape):
        a, b = max(s, o), min(s + n, o + m)
        if a >= b:
            return from_local(out, buf)        # nothing of it lands here
        dst.append(slice(a - o, b - o))
        src.append(slice(a - s, b - s))
    _bytes(out)[tuple(dst)] = _bytes(upd.to(buf.dtype))[tuple(src)]
    return from_local(out, buf)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """An f8 tensor as its raw bytes, so that indexing kernels that do not
    dispatch on float8 move it bit for bit; any other tensor as it is."""
    return t.view(torch.uint8) if t.dtype == F8_DTYPE else t


def index_select(x: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """``torch.index_select`` for every dtype, f8 included; a DTensor
    ``x`` is read with ``dim`` whole and keeps its other dims' layout."""
    if sharding.is_dtensor(idx):
        idx = idx.full_tensor()
    return on_local(
        lambda t: torch.index_select(_bytes(t), dim, idx).view(t.dtype),
        x, (dim,))


def index_copy(x: torch.Tensor, dim: int, idx: torch.Tensor,
               src: torch.Tensor) -> torch.Tensor:
    """``x.index_copy(dim, idx, src)`` (a new tensor) for every dtype,
    ``src`` cast to ``x``'s dtype first. A DTensor ``x`` is written with
    ``dim`` whole, ``src`` laid out as ``x``, and keeps its layout."""
    if sharding.is_dtensor(idx):
        idx = idx.full_tensor()
    if not sharding.is_dtensor(x):
        if sharding.is_dtensor(src):
            src = src.full_tensor()
        return _bytes(x).index_copy(dim, idx,
                                    _bytes(src.to(x.dtype))).view(x.dtype)
    x = redistribute("reshard", x, without_dims(x.placements, (dim,), x.ndim))
    src = redistribute("reshard", as_dtensor(src, x), x.placements)
    out = _bytes(x.to_local()).index_copy(
        dim, idx, _bytes(src.to_local().to(x.dtype))).view(x.dtype)
    return from_local(out, x)


def _row_starts(ndim: int, axis: int, slot) -> list:
    starts = [0] * ndim
    starts[axis] = int(slot)
    return starts


def _int8_reshard(kind: str, x: torch.Tensor, logical_axes, block: int
                  ) -> torch.Tensor:
    """``x`` moved to the layout of ``logical_axes`` as blockwise int8
    along its trailing axis: quantized on each rank's shard, the s8 values
    and the f32 scales redistributed (their bytes counted under ``kind``),
    dequantized on arrival, in ``x``'s dtype.

    Outside a context, or for a plain tensor, the one-device round trip.
    A shard of the trailing axis is quantized where it lies when it holds
    whole blocks, and gathered first otherwise, so the blocks, and the
    values, are the one-device round trip's in every layout."""
    if sharding.current_context() is None or not sharding.is_dtensor(x):
        q, scales = quantize_int8_lastdim(x, block)
        return dequantize_int8_lastdim(q, scales).to(x.dtype)
    nd = x.ndim
    b, nb = lastdim_blocks(x.shape[-1], block)
    src = without_dims(x.placements, (), nd)          # pending sums reduced
    x = redistribute(kind, x, src)
    if x.to_local().shape[-1] % b:
        x = redistribute(kind, x, without_dims(src, (nd - 1,), nd))
    local = x.to_local()
    q_l, s_l = _quantize_blocks(local.float().reshape(
        tuple(local.shape[:-1]) + (local.shape[-1] // b, b)))
    q = from_local(q_l.reshape(local.shape), x)
    scales = from_local(s_l, x)
    target = target_placements(x.shape, logical_axes)
    q = redistribute(kind, q, without_dims(target, (nd - 1,), nd))
    scales = redistribute(kind, scales, target_placements(
        scales.shape, tuple(logical_axes[:-1]) + (None,)))
    out = dequantize_int8_lastdim(q.to_local(), scales.to_local())
    out = from_local(out.to(x.dtype), q)
    return redistribute(kind, out, target)


def _movedim(x, src: int, dst: int):
    """``torch.movedim`` of one axis, a DTensor's shards moved with it."""
    if not sharding.is_dtensor(x):
        return torch.movedim(x, src, dst)
    from torch.distributed.tensor import Shard

    order = list(range(x.ndim))
    order.insert(dst % x.ndim, order.pop(src % x.ndim))
    place = tuple(Shard(order.index(p.dim % x.ndim)) if p.is_shard() else p
                  for p in x.placements)
    return from_local(torch.movedim(x.to_local(), src, dst), x, place,
                      shape=[x.shape[i] for i in order])


def stream_int8(x: torch.Tensor, *logical_axes: Optional[str],
                seq_axis: int, block: int = ACT_BLOCK) -> torch.Tensor:
    """A cache leaf moved to the layout named by ``logical_axes`` as
    seq-blockwise s8 chunks and f32 scales (counted as
    ``cache_stream_int8``), dequantized on arrival, in ``x``'s dtype.
    ``logical_axes`` names the target (decode-side) layout in the leaf's
    own axis order; ``seq_axis`` is the sequence axis. On one device
    there is no reshard, so only the round trip's rounding is real."""
    axes = list(logical_axes)
    axes.append(axes.pop(seq_axis))          # seq-last, matching q's layout
    moved = _int8_reshard("cache_stream_int8", _movedim(x, seq_axis, -1),
                          axes, block)
    return _movedim(moved, -1, seq_axis).to(x.dtype)


def stream_slot_int8(cache_leaf: torch.Tensor, new_slice: torch.Tensor, slot,
                     *logical_axes: Optional[str], seq_axis: int,
                     batch_axis: int = 1, block: int = ACT_BLOCK
                     ) -> torch.Tensor:
    """One request's cache slice through :func:`stream_int8` to the slot
    row's layout (``logical_axes``), written into row ``slot`` along
    ``batch_axis`` of the running decode cache leaf (a new tensor; the
    slot clamped as XLA clamps it)."""
    arrived = stream_int8(new_slice, *logical_axes, seq_axis=seq_axis,
                          block=block).to(cache_leaf.dtype)
    return update_slice(cache_leaf, arrived,
                        _row_starts(cache_leaf.ndim, batch_axis, slot))


def stream_row_int8(cache_leaf: torch.Tensor, new_row: torch.Tensor, slot,
                    *logical_axes: Optional[str], batch_axis: int = 0,
                    block: int = ACT_BLOCK) -> torch.Tensor:
    """Per-row variant for state leaves with no sequence axis (SSM conv
    and state, mLSTM C/n/m, sLSTM h/c/n/m): the row quantized blockwise
    along its trailing feature axis, moved to ``logical_axes``' layout as
    s8 and scales, dequantized, and written into row ``slot`` along
    ``batch_axis``."""
    arrived = _int8_reshard("cache_stream_int8", new_row, logical_axes,
                            block).to(cache_leaf.dtype)
    return update_slice(cache_leaf, arrived,
                        _row_starts(cache_leaf.ndim, batch_axis, slot))


class _TraceScope(threading.local):
    """Thread-local value stack behind the serve-path knobs (activation
    transport, KV storage). ``None`` pushed into a scope normalizes to the
    stack's default; an empty stack reads as the default too. The
    reference's scopes act at trace time; the port's steps run eagerly,
    so a step enters its scopes around every call."""

    def __init__(self, name: str, allowed: Tuple[str, ...],
                 default: Optional[str] = None):
        self.name = name
        self.allowed = allowed
        self.default = default
        self.items: list = []

    def current(self) -> Optional[str]:
        return self.items[-1] if self.items else self.default


class _trace_scope_ctx:
    def __init__(self, stack: _TraceScope, mode: Optional[str]):
        if mode is not None and mode not in stack.allowed:
            raise ValueError(f"unknown {stack.name} {mode!r}; "
                             f"expected one of {stack.allowed}")
        self.stack = stack
        self.mode = stack.default if mode is None else mode

    def __enter__(self) -> "_trace_scope_ctx":
        self.stack.items.append(self.mode)
        return self

    def __exit__(self, *exc) -> bool:
        self.stack.items.pop()
        return False


_act_ctx = _TraceScope("act_transport", ACT_TRANSPORTS, None)


def current_act_transport() -> Optional[str]:
    """Active serve activation transport, or None outside any scope."""
    return _act_ctx.current()


def act_transport_scope(mode: Optional[str]) -> _trace_scope_ctx:
    """Scope selecting how serve activation all-gathers cross the wire:
    ``"bf16"`` (a plain reshard), ``"int8"`` (blockwise int8 chunks and
    scales) or ``None`` (no boundary). Entered by the prefill and decode
    steps; model code reads it through :func:`act_gather`."""
    return _trace_scope_ctx(_act_ctx, mode)


def all_gather_int8(x: torch.Tensor, *logical_axes: Optional[str],
                    block: int = ACT_BLOCK) -> torch.Tensor:
    """``x`` resharded to the layout named by ``logical_axes`` moving
    blockwise int8 and per-block f32 scales instead of the raw payload:
    quantized on each rank's shard along the trailing axis (blocks never
    cross a shard of the leading axes), the s8 values and scales
    redistributed (counted as ``act_gather_int8``), dequantized on the
    gathered side, in ``x``'s dtype. On one device the gather moves
    nothing, but the round trip's rounding is real, as it is in the
    reference on a (1, 1) mesh.

    An int8- or f8-resident cache passes through as a plain reshard
    (counted as ``act_gather_bf16``): it is as small as the transport
    could make it."""
    if x.dtype in (torch.int8, F8_DTYPE):
        return reshard("act_gather_bf16", x, *logical_axes)
    return _int8_reshard("act_gather_int8", x, logical_axes, block)


_kv_ctx = _TraceScope("kv_storage", KV_STORAGES, "bf16")


def current_kv_storage() -> str:
    """Active decode-cache storage dtype ("bf16" outside any scope)."""
    return _kv_ctx.current()


def kv_storage_scope(mode: Optional[str]) -> _trace_scope_ctx:
    """Scope selecting the decode KV cache's resident dtype: ``"bf16"``
    (the default), ``"int8"`` (blockwise-int8 values plus f32 scales along
    the trailing feature axis) or ``"f8"`` (scale-free e4m3). Entered by
    ``make_decode_step``; attention layers read it through
    :func:`current_kv_storage`."""
    return _trace_scope_ctx(_kv_ctx, mode)


def act_gather(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The serve activation all-gather boundary: the identity outside any
    :func:`act_transport_scope` (training), a plain reshard under
    ``"bf16"`` (counted as ``act_gather_bf16``), and
    :func:`all_gather_int8` under ``"int8"``."""
    mode = current_act_transport()
    if mode is None:
        return x
    if mode == "int8":
        return all_gather_int8(x, *logical_axes)
    return reshard("act_gather_bf16", x, *logical_axes)
