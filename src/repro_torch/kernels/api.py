"""Tunable-op registry: one surface for every kernel family of the port.

An op declares

  * its tunable axes (name -> ordered candidate values) and the
    deterministic default point,
  * its kernel path (``run(point, *args, **kw)``) and plain PyTorch
    version (``ref(*args, **kw)``),
  * a ``clamp`` rule that fits any tuned/passed point to the actual
    operand extents (a point cached from a long shape must not fail or
    mis-grid on a shorter one),
  * a ``shape_key`` that names the (shape, dtype) cell a tuned point is
    cached under, and
  * representative ``example`` shapes a sweep tunes on.

``call(name, ...)`` is the single dispatch: resolve the point (explicit
override > persisted tuned cache (``repro_torch.kernels.tuned``) >
default), clamp it, run.

The backend follows the operands: an op's ``run`` launches its CUDA kernel
on CUDA tensors and takes the kernel's plain version on CPU tensors. There
is no global backend switch and no fallback from a CUDA tensor to the plain
version.

``exact_axes`` names the axes along which the op's output is provably
invariant bit-for-bit (pure data movement, or tiling that never regroups
a reduction).
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple


def fit_block(value: int, extent: int) -> int:
    """Clamp a block size to an operand extent, keeping divisibility.

    Every kernel grid requires ``extent % block == 0``. A tuned point
    cached from a long shape applied to a shorter one must degrade
    deterministically, never assert: clamp to the extent, and if the
    clamped value does not divide it, fall back to gcd(value, extent) --
    always a divisor, always <= value.
    """
    if extent <= 0:
        return max(1, value)
    v = min(int(value), extent)
    if v <= 0:
        v = 1
    if extent % v == 0:
        return v
    return math.gcd(v, extent)


@dataclasses.dataclass(frozen=True)
class TunableOp:
    """One registered kernel family and everything a sweep needs."""
    name: str
    axes: Mapping[str, Tuple]            # axis -> ordered candidate values
    default: Mapping[str, Any]           # the deterministic default point
    run: Callable                        # run(point, *args, **kw) -> out
    ref: Callable                        # ref(*args, **kw) -> out
    clamp: Callable                      # clamp(point, *args, **kw) -> point
    shape_key: Callable                  # shape_key(*args, **kw) -> str
    example: Callable                    # example(quick: bool) -> (args, kw)
    exact_axes: frozenset = frozenset()  # axes that provably keep bits
    tol: float = 0.0                     # |kernel - ref| bound (0 = exact)


_REGISTRY: Dict[str, TunableOp] = {}

# ops.py modules that register the built-in kernel families on import;
# imported lazily so this module never cycles with the packages that
# import it.
_BUILTIN_OPS = (
    "repro_torch.kernels.compact_pack.ops",
)


def register(op: TunableOp) -> TunableOp:
    for axis in op.default:
        if axis not in op.axes:
            raise ValueError(f"{op.name}: default names unknown axis {axis!r}")
    for axis, vals in op.axes.items():
        if axis not in op.default:
            raise ValueError(f"{op.name}: axis {axis!r} has no default")
        if op.default[axis] not in vals:
            raise ValueError(f"{op.name}: default {op.default[axis]!r} not "
                             f"among candidates for axis {axis!r}")
    _REGISTRY[op.name] = op
    return op


def ensure_registered() -> None:
    for mod in _BUILTIN_OPS:
        importlib.import_module(mod)


def get_op(name: str) -> TunableOp:
    if name not in _REGISTRY:
        ensure_registered()
    return _REGISTRY[name]


def ops() -> Dict[str, TunableOp]:
    ensure_registered()
    return dict(_REGISTRY)


def default_point(op: TunableOp) -> Dict[str, Any]:
    return dict(op.default)


def resolve_point(op: TunableOp, *args, **kwargs) -> Dict[str, Any]:
    """Tuned-cache lookup at op-call time, deterministic default fallback.

    Cache entries are keyed (op, shape_key, device_kind); a miss -- no
    file, unknown shape, stale device kind, corrupt JSON -- silently
    yields the default point. Unknown axes in a cached point are dropped
    rather than trusted.
    """
    from repro_torch.kernels import tuned  # local: keep api import-light

    point = default_point(op)
    cached = tuned.lookup(op.name, op.shape_key(*args, **kwargs))
    if cached:
        for axis in op.axes:
            if axis in cached:
                point[axis] = cached[axis]
    return point


def call(name: str, *args, point: Optional[Mapping[str, Any]] = None,
         use_ref: bool = False, **kwargs):
    """Dispatch one op: explicit point > tuned cache > default, clamped."""
    op = get_op(name)
    if use_ref:
        return op.ref(*args, **kwargs)
    if point is None:
        point = resolve_point(op, *args, **kwargs)
    else:
        merged = default_point(op)
        merged.update({a: v for a, v in point.items() if a in op.axes})
        point = merged
    point = op.clamp(dict(point), *args, **kwargs)
    return op.run(point, *args, **kwargs)


def clamped_axes(op: TunableOp, *args, **kwargs) -> Dict[str, Tuple]:
    """The op's candidate values after clamping to these operands, deduped
    in candidate order -- the space a sweep actually covers."""
    out: Dict[str, Tuple] = {}
    base = default_point(op)
    for axis, vals in op.axes.items():
        seen = []
        for v in vals:
            c = op.clamp({**base, axis: v}, *args, **kwargs)[axis]
            if c not in seen:
                seen.append(c)
        out[axis] = tuple(seen)
    return out
