"""Roofline instrumentation: the cost walk, the collective meter and the
HLO-text parser.

The port of ``src/repro/launch/analysis.py``. The reference walks a
jaxpr, multiplying through ``scan`` trip counts, and parses the compiled
per-device HLO for its collectives. The port has no jaxpr and no HLO: its
steps are eager Python. So:

1. ``jaxpr_cost(fn, *args)`` runs ``fn`` once on fake tensors
   (``FakeTensorMode``: shapes and dtypes, no data, no device work) under
   :class:`CostMode`, a dispatch mode that prices each op as
   ``_dot_cost`` and ``_jaxpr_cost`` price its JAX counterpart:

   - ``dot_flops``: 2 * batch * m * n * k for each contraction. The
     port's ``models.common.einsum`` reports each call as the pairwise
     ``dot_general``s ``jnp.einsum`` lowers it to (opt_einsum's optimal
     order, an index kept by both operands and the result a batch dim), so
     an outer product, which torch lowers to a multiply, counts with
     k = 1 as in the reference; the aten ops inside that call are not
     counted again. Every other contraction is counted where it reaches
     ``aten.mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv`` or ``dot``.
   - ``hbm_bytes``: each contraction's operands plus its output, once.
   - ``flops``: ``dot_flops`` plus one per output element of every other
     op that is not on the zero-flop list, :data:`ZERO_FLOP_OPS`: the aten
     views, copies, casts, index, pad, cat and creation ops that
     correspond to the reference's ``_ZERO_FLOP_PRIMS``. torch splits
     some ops otherwise than XLA (a softmax is one aten op and five JAX
     primitives), so ``flops`` is close to the reference's, not equal.

   A body the reference runs as a ``scan`` (a layer, an attention tile, a
   recurrent step, a microbatch's gradients) is marked with
   ``models.common.repeated``; the walk runs it once per distinct input
   signature and replays its counts, and fake outputs of its shapes, for
   each further call with no gradient to carry
   (:class:`_Replay`), as the reference multiplies a ``scan`` body's cost
   by its length. Eager torch has no ``cond``: a Python branch runs the
   one side it takes, so the reference's worst-branch rule does not
   arise.

2. :class:`CollectiveMode` counts the collectives a step issues on a
   ``DeviceMesh`` (DTensor's own redistributions through the functional
   collectives, and every plain c10d collective) by the reference's five
   HLO op names, with the reference's keys: payload bytes, the
   bf16-equivalent bytes, and the ring model's wire bytes
   (:func:`_wire_bytes`). It is what the dry run reads in place of
   ``hlo_collective_bytes`` of the compiled program, and
   :func:`collective_meter` is the wire meter of
   ``launch.serve.disagg_decode_report``.

3. ``model_flops`` and the HLO-text parser (``hlo_collective_bytes``,
   ``top_collectives``) are the reference's, copied unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import re
import types
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models import common

aten = torch.ops.aten

# ---------------------------------------------------------------------------
# the cost walk
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0

    def __iadd__(self, o):
        self.flops += o.flops
        self.dot_flops += o.dot_flops
        self.hbm_bytes += o.hbm_bytes
        return self

    def scaled(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.dot_flops * k, self.hbm_bytes * k)


# The reference's _ZERO_FLOP_PRIMS (reshape, transpose, broadcast_in_dim,
# convert_element_type, squeeze, slice, dynamic_slice,
# dynamic_update_slice, concatenate, pad, rev, copy, stop_gradient, iota,
# gather, scatter, split, sharding_constraint) as the aten ops they
# become: views and reshapes; permutes and transposes; expands and
# creation ops (a broadcast, a constant or an iota: empty, zeros, full,
# arange, scalar_tensor); dtype casts and copies (_to_copy, clone, copy_,
# detach); slices, selects and their scatters back (slice_backward,
# slice_scatter, select_backward, select_scatter, index_put: the
# dynamic_update_slice); index, index_select, gather, embedding (the
# gather); scatter; cat and stack (concatenate); split and unbind;
# constant_pad_nd (pad); flip (rev). Also the ops that move no element:
# a device query, a scalar read, a lifted constant. A scatter that adds
# (scatter_add, index_add) is the reference's scatter-add, not scatter,
# and counts.
ZERO_FLOP_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "view_as",
    "as_strided", "alias", "permute", "transpose", "t", "expand",
    "expand_as", "squeeze", "unsqueeze", "unflatten", "flatten",
    "movedim", "broadcast_to", "repeat",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones",
    "ones_like", "new_ones", "full", "full_like", "new_full", "fill",
    "fill_", "zero_", "arange", "scalar_tensor", "lift_fresh",
    "lift_fresh_copy",
    "_to_copy", "to", "clone", "copy", "copy_", "detach", "_copy_from",
    "_copy_from_and_resize", "contiguous",
    "slice", "select", "narrow", "slice_backward", "slice_scatter",
    "select_backward", "select_scatter", "index_put", "index_put_",
    "_index_put_impl_", "index", "_unsafe_index", "index_select",
    "gather", "embedding", "scatter", "scatter_", "cat", "stack",
    "split", "split_with_sizes", "unbind", "chunk", "constant_pad_nd",
    "flip", "device", "_local_scalar_dense", "item",
})

# aten contractions: (op, how to read its operands)
_MM = {aten.mm.default, aten.bmm.default}
_ADDMM = {aten.addmm.default, aten.baddbmm.default}
_VEC = {aten.mv.default, aten.dot.default}


def _nbytes(t) -> float:
    return float(t.numel()) * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _aten_dot(a, b, out) -> Cost:
    """``a @ b`` of mm, bmm, mv or dot: 2 * (output elements) * k."""
    k = a.shape[-1]
    flops = 2.0 * float(out.numel()) * k
    return Cost(flops=flops, dot_flops=flops,
                hbm_bytes=_nbytes(a) + _nbytes(b) + _nbytes(out))


def _einsum_path(inputs: List[frozenset], output: frozenset,
                 sizes: Dict[str, int]) -> List[Tuple[int, int]]:
    """opt_einsum's "optimal" contraction order, which ``jnp.einsum``'s
    default ``optimize="auto"`` takes for up to four operands: every
    pairwise order, each pair priced by the size of its index union,
    doubled when it sums an index out; the cheapest total, the first found
    on a tie; each pair's result appended after the operands left."""
    best: Dict[str, Any] = {"cost": None, "path": []}

    def size(idx):
        n = 1
        for c in idx:
            n *= sizes[c]
        return n

    def walk(ops, cost, path):
        if len(ops) == 1:
            if best["cost"] is None or cost < best["cost"]:
                best["cost"], best["path"] = cost, path
            return
        for i, j in itertools.combinations(range(len(ops)), 2):
            rest = [o for n, o in enumerate(ops) if n not in (i, j)]
            union = ops[i] | ops[j]
            keep = union & (output.union(*rest))
            step = size(union) * (2 if union - keep else 1)
            if best["cost"] is not None and cost + step >= best["cost"]:
                continue
            walk(rest + [keep], cost + step, path + [(i, j)])

    walk(list(inputs), 0, [])
    return best["path"]


def einsum_cost(eq: str, shapes: Sequence[Sequence[int]],
                itemsize: int) -> Cost:
    """The cost the reference's walk gives ``jnp.einsum(eq, ...)`` over
    operands of ``shapes`` in a dtype of ``itemsize`` bytes: one
    ``dot_general`` per pairwise contraction (an index both operands and
    the result keep is a batch dim, an index only one operand sums out is
    a ``reduce_sum`` first), at 2 * batch * m * n * k flops and its
    operands' and output's bytes."""
    subs, out = common._explicit(
        eq, [types.SimpleNamespace(ndim=len(s)) for s in shapes])
    sizes: Dict[str, int] = {}
    for sub, shape in zip(subs, shapes):
        sizes.update(zip(sub, (int(d) for d in shape)))

    def size(idx):
        n = 1
        for c in idx:
            n *= sizes[c]
        return float(n)

    cost = Cost()
    ops = [frozenset(s) for s in subs]
    if len(ops) == 1:
        if set(subs[0]) - set(out):              # a reduce_sum
            cost.flops += size(out)
        return cost
    final = frozenset(out)
    for i, j in _einsum_path(ops, final, sizes):
        a, b = ops[i], ops[j]
        rest = [o for n, o in enumerate(ops) if n not in (i, j)]
        keep = (a | b) & final.union(*rest)
        gone = (a | b) - keep
        for side, other in ((a, b), (b, a)):     # indices summed out alone
            if side & gone - other:
                cost.flops += size(side - (gone - other))
        a, b = a - (gone - b), b - (gone - a)
        k = size(a & b & gone)
        batch = size(a & b & keep)
        m, n = size(a - b), size(b - a)
        flops = 2.0 * batch * m * n * k
        cost += Cost(flops=flops, dot_flops=flops,
                     hbm_bytes=(size(a) + size(b) + size(keep)) * itemsize)
        ops = rest + [keep]
    return cost


class CostMode(TorchDispatchMode):
    """Prices every op it sees (see the module's docstring); read
    ``cost``. Inside a ``models.common.einsum`` call only the call itself
    counts (:meth:`einsum`)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._inside = 0

    @contextlib.contextmanager
    def einsum(self, eq: str, operands):
        if self._inside == 0:
            self.cost += einsum_cost(eq, [tuple(t.shape) for t in operands],
                                     operands[0].element_size())
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1

    def snapshot(self) -> Cost:
        return dataclasses.replace(self.cost)

    def since(self, before: Cost) -> Cost:
        return Cost(self.cost.flops - before.flops,
                    self.cost.dot_flops - before.dot_flops,
                    self.cost.hbm_bytes - before.hbm_bytes)

    def add(self, delta: Cost) -> None:
        self.cost += delta

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self._inside:
            return out
        if func in _MM or func in _VEC:
            self.cost += _aten_dot(args[0], args[1], out)
        elif func in _ADDMM:
            self.cost += _aten_dot(args[1], args[2], out)
            self.cost.flops += float(out.numel())          # the bias add
        elif func.__name__.split(".")[0] not in ZERO_FLOP_OPS:
            self.cost.flops += float(sum(t.numel() for t in _tensors(out)))
        return out


# ---------------------------------------------------------------------------
# replaying a repeated body: the scan's trip count
# ---------------------------------------------------------------------------

def _signature(x) -> Any:
    """A hashable key of ``x``'s structure: each tensor's shape, stride,
    dtype, device, whether it needs a gradient and, for a DTensor, its
    mesh and placements; any other leaf by value (or by identity when it
    does not hash)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return ("D", tuple(x.shape), x.dtype, id(x.device_mesh),
                tuple(x.placements), _signature(x.to_local()))
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), tuple(x.stride()), x.dtype,
                str(x.device), x.requires_grad)
    if isinstance(x, dict):
        return ("d",) + tuple((k, _signature(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_signature(v) for v in x)
    try:
        hash(x)
        return x
    except TypeError:
        return ("id", id(x))


def _template(x) -> Any:
    """``x`` with each tensor replaced by what :func:`_instantiate` needs
    to make a fake tensor like it."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return ("D", _template(x.to_local()), x.device_mesh,
                tuple(x.placements), tuple(x.shape), tuple(x.stride()))
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), tuple(x.stride()), x.dtype, x.device)
    if isinstance(x, dict):
        return {k: _template(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_template(v) for v in x)
    return ("V", x)


def _instantiate(t) -> Any:
    if isinstance(t, dict):
        return {k: _instantiate(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)) and not (t and isinstance(t[0], str)):
        return type(t)(_instantiate(v) for v in t)
    if t[0] == "T":
        _, shape, stride, dtype, device = t
        return torch.empty_strided(shape, stride, dtype=dtype, device=device)
    if t[0] == "D":
        from torch.distributed.tensor import DTensor

        _, local, mesh, place, shape, stride = t
        return DTensor.from_local(_instantiate(local), mesh, place,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=stride)
    return t[1]


class _Replay:
    """``models.common.repeated``'s hook during a walk: the first call of
    a body with a given input signature runs, and each meter's counts over
    it are kept with its outputs' shapes; a further call with that
    signature and no gradient to carry (grad mode off, or no input that
    needs one) adds the kept counts and returns fresh fake outputs of
    those shapes without running. A call that carries a gradient always
    runs: its outputs must join the autograd graph."""

    def __init__(self, meters):
        self.meters = list(meters)
        self.memo: Dict[Any, Tuple[list, Any]] = {}
        self.runs = 0
        self.replays = 0

    def __call__(self, fn, args, kwargs):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in _tensors((args, kwargs))):
            return fn(*args, **kwargs)
        key = (fn, _signature((args, kwargs)))
        hit = self.memo.get(key)
        if hit is None:
            before = [m.snapshot() for m in self.meters]
            out = fn(*args, **kwargs)
            self.memo[key] = ([m.since(b) for m, b in
                               zip(self.meters, before)], _template(out))
            self.runs += 1
            return out
        deltas, tmpl = hit
        for m, d in zip(self.meters, deltas):
            m.add(d)
        self.replays += 1
        return _instantiate(tmpl)


@contextlib.contextmanager
def hooked(replay: Optional[_Replay] = None,
           einsum_observer: Optional[Callable] = None):
    """Install ``replay`` as ``models.common.repeated``'s hook and
    ``einsum_observer`` as ``models.common.einsum``'s for the block."""
    old = common._replay, common._einsum_observer
    common._replay, common._einsum_observer = replay, einsum_observer
    try:
        yield
    finally:
        common._replay, common._einsum_observer = old


def fake_tree(tree, device) -> Any:
    """Each ``TensorSpec`` leaf of ``tree`` (anything with ``shape`` and
    ``dtype`` that is not a tensor) as an empty tensor on ``device``:
    call it inside a ``FakeTensorMode`` for fake ones. Tensors pass."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        return {k: fake_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fake_tree(v, device) for v in tree)
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return torch.empty(tuple(tree.shape), dtype=tree.dtype,
                           device=device)
    return tree


def fake_mode():
    """A ``FakeTensorMode`` that also takes real tensors (read as
    constants of their shape)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def jaxpr_cost(fn, *args, device="cpu") -> Dict[str, float]:
    """``{"flops", "dot_flops", "hbm_bytes"}`` of one call of ``fn`` on
    ``args`` (trees of ``TensorSpec``s or tensors), run on fake tensors on
    ``device`` (nothing runs on it): the reference's global cost of the
    one-device step, before the dry run divides it by the chips."""
    with fake_mode():
        fargs = [fake_tree(a, torch.device(device)) for a in args]
        mode = CostMode()
        with hooked(_Replay([mode]), mode.einsum), mode:
            fn(*fargs)
    c = mode.cost
    return {"flops": c.flops, "dot_flops": c.dot_flops,
            "hbm_bytes": c.hbm_bytes}


# ---------------------------------------------------------------------------
# the reference's pure half, copied unchanged
# ---------------------------------------------------------------------------

def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D train (N_active for MoE), 2*N*D forward-only."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: 1 token/seq


# ---------------------------------------------------------------------------
# HLO collective parsing with loop trip counts
# ---------------------------------------------------------------------------

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
# iota form "replica_groups=[2,4]<=[8]" and list form "replica_groups={{0,2},..."
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")
# computation header: "%name (args...) -> type {" — args may contain nested
# parens (tuple-typed params), so only anchor on the leading name.
_COMP_START_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(")
_WHILE_RE = re.compile(
    r"while\(.*?\)[^{]*?condition=%?([\w.\-]+)[^{]*?body=%?([\w.\-]+)")
_CALL_RE = re.compile(r"(?:calls|to_apply|body|condition|branch_computations)="
                      r"\{?%?([\w.\-]+(?:,\s*%?[\w.\-]+)*)\}?")
_CONST_RE = re.compile(r"=\s*s32\[\]\s*constant\((\d+)\)")

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}


def _shape_bytes(dtype: str, dims: str) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def _split_computations(text: str) -> Dict[str, List[str]]:
    comps: Dict[str, List[str]] = {}
    cur: Optional[str] = None
    depth = 0
    for line in text.splitlines():
        s = line.strip()
        if cur is None:
            m = _COMP_START_RE.match(s)
            if m and s.endswith("{") and "->" in s:
                cur = m.group(1)
                comps[cur] = []
                depth = 1
            continue
        depth += s.count("{") - s.count("}")
        if depth <= 0:
            cur = None
            continue
        comps[cur].append(s)
    return comps


def _group_size(s: str) -> int:
    """Replica-group size of a collective line; 0 when unparseable."""
    m = _GROUPS_IOTA_RE.search(s)
    if m:
        return int(m.group(2))
    m = _GROUPS_LIST_RE.search(s)
    if m:
        return len([t for t in m.group(1).split(",") if t.strip()])
    return 0


def _wire_bytes(op: str, full_bytes: float, g: int) -> float:
    """Per-device link traffic under the standard ring algorithms.

    ``full_bytes`` is the logical full-array payload (the result shape for
    all ops except reduce-scatter, whose result is 1/g of it). Ring
    all-reduce moves 2(g-1)/g of the array (reduce-scatter + all-gather
    phases); all-gather / reduce-scatter / all-to-all move (g-1)/g; a
    permute moves the array once. Unknown group size assumes a large group.
    """
    frac = (g - 1) / g if g > 1 else (1.0 if g == 0 else 0.0)
    if op == "all-reduce":
        return 2.0 * frac * full_bytes
    if op == "collective-permute":
        return float(full_bytes)
    return frac * full_bytes


def _collective_line_bytes(s: str
                           ) -> Optional[Tuple[str, int, int, int, int, int]]:
    """(op, bytes, bf16-eq bytes, wire bytes, bf16-eq wire bytes, s8 wire).

    ``bytes`` is the result-shape payload (legacy metric); ``wire_bytes``
    models what actually crosses the links (see :func:`_wire_bytes`). The
    CPU backend promotes bf16 dots to f32, so weight/activation collectives
    appear at 2x their TPU size; the bf16-equivalent numbers halve f32
    collective payloads (TPU keeps them bf16). The trailing element is the
    bf16-eq wire bytes of the *int8 part* of the payload — how much of the
    line's traffic a quantized transport actually moved as s8 (scales and
    other operands excluded), used by the serve act_transport comparison.
    """
    for op in COLLECTIVE_OPS:
        idx = s.find(op + "(")
        if idx < 0 or op + "-done" in s:
            continue
        eq = s.find(" = ")
        if eq < 0 or eq > idx:
            continue
        result = s[eq + 3:idx]
        byts = 0
        byts_eq = 0.0
        byts_eq_s8 = 0.0
        for m in _SHAPE_RE.finditer(result):
            b = _shape_bytes(m.group(1), m.group(2))
            byts += b
            byts_eq += b * (0.5 if m.group(1) == "f32" else 1.0)
            if m.group(1) == "s8":
                byts_eq_s8 += b
        g = _group_size(s)
        if op == "reduce-scatter":
            mul = g if g else 1
            byts *= mul
            byts_eq *= mul
            byts_eq_s8 *= mul
        wire = _wire_bytes(op, byts, g)
        wire_eq = _wire_bytes(op, byts_eq, g)
        wire_eq_s8 = _wire_bytes(op, byts_eq_s8, g)
        return op, byts, int(byts_eq), int(wire), int(wire_eq), int(wire_eq_s8)
    return None


def _cond_trip_count(lines: List[str]) -> int:
    consts = [int(m.group(1)) for line in lines for m in _CONST_RE.finditer(line)]
    return max(consts) if consts else 1


def hlo_collective_bytes(text: str) -> Dict[str, Any]:
    comps = _split_computations(text)
    entry = None
    for line in text.splitlines():
        if line.startswith("ENTRY"):
            m = _COMP_START_RE.match(line.strip())
            if m:
                entry = m.group(1)
    if entry is None:  # fall back: flat scan, no multipliers
        entry_lines = [l for ls in comps.values() for l in ls]
        comps = {"__entry__": entry_lines}
        entry = "__entry__"

    memo: Dict[str, Dict[str, Any]] = {}
    _KEYS = ("count", "bytes", "bytes_bf16eq", "wire_bytes",
             "wire_bytes_bf16eq", "wire_bytes_bf16eq_s8")

    def zero():
        return {op: {k: 0 for k in _KEYS} for op in COLLECTIVE_OPS}

    def visit(name: str, stack=()) -> Dict[str, Any]:
        if name in memo:
            return memo[name]
        if name in stack or name not in comps:
            return zero()
        agg = zero()
        for s in comps[name]:
            hit = _collective_line_bytes(s)
            if hit:
                op, byts, byts_eq, wire, wire_eq, wire_eq_s8 = hit
                agg[op]["count"] += 1
                agg[op]["bytes"] += byts
                agg[op]["bytes_bf16eq"] += byts_eq
                agg[op]["wire_bytes"] += wire
                agg[op]["wire_bytes_bf16eq"] += wire_eq
                agg[op]["wire_bytes_bf16eq_s8"] += wire_eq_s8
            wm = _WHILE_RE.search(s)
            if wm:
                cond, body = wm.group(1), wm.group(2)
                trips = _cond_trip_count(comps.get(cond, []))
                sub = visit(body, stack + (name,))
                for op in COLLECTIVE_OPS:
                    for k in _KEYS:
                        agg[op][k] += sub[op][k] * trips
                continue
            for cm in _CALL_RE.finditer(s):
                for callee in re.split(r",\s*%?", cm.group(1)):
                    if callee in ("", name) or callee in (wm.groups() if wm else ()):
                        continue
                    sub = visit(callee, stack + (name,))
                    for op in COLLECTIVE_OPS:
                        for k in _KEYS:
                            agg[op][k] += sub[op][k]
        memo[name] = agg
        return agg

    agg = visit(entry)
    for k in ("bytes", "bytes_bf16eq", "wire_bytes", "wire_bytes_bf16eq",
              "wire_bytes_bf16eq_s8"):
        agg["total_" + k] = sum(v[k] for v in agg.values()
                                if isinstance(v, dict))
    return agg


def top_collectives(text: str, n: int = 20):
    """Dynamic (trip-count-multiplied) collective tally grouped by shape —
    the §Perf profiling view."""
    comps = _split_computations(text)
    entry = None
    for line in text.splitlines():
        if line.startswith("ENTRY"):
            entry = _COMP_START_RE.match(line.strip()).group(1)
    tally: Dict[Tuple[str, str], List[float]] = {}

    def visit(name, mult, stack=()):
        if name in stack or name not in comps:
            return
        for s in comps[name]:
            hit = _collective_line_bytes(s)
            if hit:
                op, byts = hit[0], hit[1]
                shape = s.split(" = ")[1].split(" ")[0][:70]
                c, b = tally.get((op, shape), (0, 0))
                tally[(op, shape)] = (c + mult, b + byts * mult)
            wm = _WHILE_RE.search(s)
            if wm:
                trips = _cond_trip_count(comps.get(wm.group(1), []))
                visit(wm.group(2), mult * trips, stack + (name,))
                continue
            for cm in _CALL_RE.finditer(s):
                for callee in re.split(r",\s*%?", cm.group(1)):
                    if callee and callee != name:
                        visit(callee, mult, stack + (name,))

    visit(entry, 1)
    rows = sorted(tally.items(), key=lambda kv: -kv[1][1])[:n]
    return [{"op": op, "shape": shape, "count": c, "bytes": b}
            for (op, shape), (c, b) in rows]


# ---------------------------------------------------------------------------
# the collectives a step issues on a DeviceMesh
# ---------------------------------------------------------------------------

_KEYS = ("count", "bytes", "bytes_bf16eq", "wire_bytes",
         "wire_bytes_bf16eq", "wire_bytes_bf16eq_s8")
_TOTALS = ("bytes", "bytes_bf16eq", "wire_bytes", "wire_bytes_bf16eq",
           "wire_bytes_bf16eq_s8")


def _group_of(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size()


def _size_of(group) -> int:
    """The size of the process group a c10d op was handed, which the
    dispatcher passes boxed."""
    from torch.distributed import ProcessGroup

    if not isinstance(group, ProcessGroup):
        group = ProcessGroup.unbox(group)
    return group.size()


def _payload(ts) -> Tuple[float, float, float]:
    """(bytes, bf16-equivalent bytes, s8 bytes) of tensors ``ts``: f32
    payloads at half their bytes, as ``_collective_line_bytes`` prices
    them."""
    b = eq = s8 = 0.0
    for t in ts:
        n = _nbytes(t)
        b += n
        eq += n * (0.5 if t.dtype == torch.float32 else 1.0)
        if t.dtype == torch.int8:
            s8 += n
    return b, eq, s8


def _collective_of(func, args, out):
    """(HLO op name, payload tensors, group size) of a collective call, or
    ``None``. The payload is the full array, as the reference's result
    shape is (an all-gather's output, a reduce-scatter's input); a
    broadcast and a send are priced as a permute: the array crosses
    once."""
    import torch.distributed._functional_collectives  # noqa: F401 (ops)

    fn = torch.ops._c10d_functional
    fa = torch.ops._c10d_functional_autograd
    c10d = torch.ops.c10d
    pkt = func._overloadpacket
    if pkt in (fn.all_gather_into_tensor, fa.all_gather_into_tensor):
        return "all-gather", [out], args[1]
    if pkt is fn.all_gather_into_tensor_coalesced:
        return "all-gather", list(out), args[1]
    if pkt in (fn.reduce_scatter_tensor, fa.reduce_scatter_tensor):
        return "reduce-scatter", [args[0]], args[2]
    if pkt is fn.reduce_scatter_tensor_coalesced:
        return "reduce-scatter", list(args[0]), args[2]
    if pkt is fn.all_reduce:
        return "all-reduce", [args[0]], _group_of(args[2])
    if pkt is fn.all_reduce_coalesced:
        return "all-reduce", list(args[0]), _group_of(args[2])
    if pkt in (fn.all_to_all_single, fa.all_to_all_single):
        return "all-to-all", [out], _group_of(args[3])
    if pkt in (fn.broadcast, fn.broadcast_):
        return "collective-permute", [args[0]], _group_of(args[2])
    if pkt in (c10d.allreduce_, c10d.allreduce_coalesced_):
        return "all-reduce", list(args[0]), _size_of(args[1])
    if pkt is c10d._allgather_base_:
        return "all-gather", [args[0]], _size_of(args[2])
    if pkt is c10d.allgather_:
        return "all-gather", [t for ts in args[0] for t in ts], \
            _size_of(args[2])
    if pkt is c10d.allgather_into_tensor_coalesced_:
        return "all-gather", list(args[0]), _size_of(args[2])
    if pkt is c10d._reduce_scatter_base_:
        return "reduce-scatter", [args[1]], _size_of(args[2])
    if pkt is c10d.reduce_scatter_:
        return "reduce-scatter", [t for ts in args[1] for t in ts], \
            _size_of(args[2])
    if pkt in (c10d.alltoall_base_, c10d.alltoall_):
        outs = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
        return "all-to-all", list(outs), _size_of(args[2])
    if pkt in (c10d.broadcast_, c10d.send):
        return "collective-permute", list(args[0]), _size_of(args[1])
    return None


def zero_collectives() -> Dict[str, Any]:
    return {op: {k: 0 for k in _KEYS} for op in COLLECTIVE_OPS}


def with_totals(agg: Dict[str, Any]) -> Dict[str, Any]:
    """``agg`` with the reference's ``total_*`` sums over the ops."""
    out = {op: dict(agg[op]) for op in COLLECTIVE_OPS}
    for k in _TOTALS:
        out["total_" + k] = sum(out[op][k] for op in COLLECTIVE_OPS)
    return out


class CollectiveMode(TorchDispatchMode):
    """Counts every collective issued under it, DTensor's included, with
    ``hlo_collective_bytes``' keys for one rank's program: per op
    ``count``, ``bytes`` (the full array), ``bytes_bf16eq``, and the ring
    wire ``_wire_bytes`` gives each, plus the s8 part's bf16-equivalent
    wire. Read :meth:`result`; :attr:`kinds` books the same rows by the
    kind the port's own collective that issued them names
    (``dist.collectives.current_kind``: ``redistribute``'s and
    ``exchange``'s ``kind``, such as ``act_gather_int8`` or
    ``cache_move_int8``, and ``"broadcast"``), ``"implicit"`` for
    DTensor's own and any other. Plain tensors, fake or real, run as
    they would; a DTensor call goes to DTensor first, whose
    redistributions come back here as functional collectives."""

    def __init__(self):
        super().__init__()
        self.agg = zero_collectives()
        self.kinds: Dict[str, Dict[str, int]] = {}

    def snapshot(self):
        return ({op: dict(v) for op, v in self.agg.items()},
                {k: dict(v) for k, v in self.kinds.items()})

    def since(self, before):
        ops, kinds = before
        zero = {k: 0 for k in _KEYS}
        return ({op: {k: self.agg[op][k] - ops[op][k] for k in _KEYS}
                 for op in COLLECTIVE_OPS},
                {kind: {k: v[k] - kinds.get(kind, zero)[k] for k in _KEYS}
                 for kind, v in self.kinds.items()})

    def add(self, delta) -> None:
        ops, kinds = delta
        for op in COLLECTIVE_OPS:
            for k in _KEYS:
                self.agg[op][k] += ops[op][k]
        for kind, v in kinds.items():
            row = self.kinds.setdefault(kind, {k: 0 for k in _KEYS})
            for k in _KEYS:
                row[k] += v[k]

    def result(self) -> Dict[str, Any]:
        return with_totals(self.agg)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        hit = _collective_of(func, args, out)
        if hit is not None:
            from repro_torch.dist.collectives import current_kind

            op, ts, g = hit
            b, eq, s8 = _payload(ts)
            kind = current_kind() or "implicit"
            kind_row = self.kinds.setdefault(kind, {k: 0 for k in _KEYS})
            for row in (self.agg[op], kind_row):
                row["count"] += 1
                row["bytes"] += int(b)
                row["bytes_bf16eq"] += int(eq)
                row["wire_bytes"] += int(_wire_bytes(op, b, g))
                row["wire_bytes_bf16eq"] += int(_wire_bytes(op, eq, g))
                row["wire_bytes_bf16eq_s8"] += int(_wire_bytes(op, s8, g))
        return out


def trace_collectives(fn: Callable[[], Any], *, replay: bool = True
                      ) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """Run ``fn()`` under a :class:`CollectiveMode`, repeated bodies
    replayed (on fake tensors; pass ``replay=False`` for real ones, whose
    collectives must all run). Returns ``(fn's result, the collectives
    with their totals, the same rows by kind)``."""
    mode = CollectiveMode()
    rep = _Replay([mode]) if replay else None
    with hooked(rep, None), mode:
        out = fn()
    return out, mode.result(), mode.kinds


def collective_meter(fn: Callable[[], Any]) -> Dict[str, int]:
    """The wire meter of ``launch.serve.disagg_decode_report``: run
    ``fn()`` once and return the bf16-equivalent ring wire of every
    collective it issued, and its s8 part, as the reference reads them
    from a compiled program's HLO."""
    _, coll, _ = trace_collectives(fn, replay=_on_fake_tensors())
    return {"total_wire_bytes_bf16eq": coll["total_wire_bytes_bf16eq"],
            "total_wire_bytes_bf16eq_s8":
                coll["total_wire_bytes_bf16eq_s8"]}


def _on_fake_tensors() -> bool:
    """Whether a ``FakeTensorMode`` is active."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None
