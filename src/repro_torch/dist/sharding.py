"""Logical-axis-rule sharding on a ``DeviceMesh``.

The port of ``src/repro/dist/sharding.py``. Model code never names mesh
axes. Parameters declare logical axes through ``Spec`` and activations
pass them to :func:`constrain`; a *rule set* maps each logical name to an
ordered tuple of candidate mesh axes. Resolution is mesh-aware, as in the
reference:

- a candidate mesh axis absent from the mesh is skipped (the same
  ``baseline`` rules drive the local ``(data, model)`` mesh and the
  production ``(pod, data, model)`` mesh);
- a dimension not divisible by a candidate axis size stays unsharded on
  that axis (Granite's vocab of 49155 stays replicated over model);
- each mesh axis is used at most once per array.

:func:`resolve_spec` gives the port's spec: a tuple with one entry per
tensor dim, ``None``, a mesh axis name, or a tuple of names (major to
minor), trailing ``None`` entries trimmed as JAX trims a
``PartitionSpec``. It takes a ``DeviceMesh``, the one-process
``LocalMesh``, or a plain ``{axis: size}`` mapping, so production meshes
resolve without their ranks. :func:`placements` turns a spec into DTensor
placements, one per mesh dim.

:func:`constrain` is the identity outside an :func:`axis_rules` context
and on a plain tensor; inside one it redistributes a DTensor to the
resolved placements, the counterpart of ``with_sharding_constraint``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

# A rule maps one logical axis name to an ordered tuple of candidate mesh
# axes; a dimension takes every candidate (in order) that is present in the
# mesh, unused by this array, and divides the remaining dimension size.
Rules = Tuple[Tuple[str, Tuple[str, ...]], ...]
Spec = Tuple[Any, ...]

_WEIGHT_RULES: Rules = (
    ("embed", ("data",)),            # FSDP/ZeRO: weights sharded over data
    ("mlp", ("model",)),
    ("expert_mlp", ("model",)),
    ("experts", ("model",)),
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("vocab", ("model",)),
    ("ssm_inner", ("model",)),
    ("kv_lora", ("model",)),
    ("q_lora", ("model",)),
)

BASE_RULES: Rules = (("batch", ("pod", "data")),) + _WEIGHT_RULES

# Expert parallelism: experts over data, the expert hidden dim over model.
_EP_RULES: Rules = (("batch", ("pod", "data")),) + tuple(
    (name, ("data",)) if name == "experts" else (name, targets)
    for name, targets in _WEIGHT_RULES)

# Pod-level FSDP: weight shards span the pod axis too.
_FSDP_RULES: Rules = (("batch", ("pod", "data")),) + tuple(
    (name, ("pod", "data")) if name == "embed" else (name, targets)
    for name, targets in _WEIGHT_RULES)

# Sharded serving: the residual stream sequence-sharded over model, the KV
# cache over data (batch) x model (sequence), weights without the FSDP
# embed shard.
_SERVE_SP_RULES: Rules = (("batch", ("pod", "data")),) + tuple(
    (name, ()) if name == "embed" else (name, targets)
    for name, targets in _WEIGHT_RULES) \
    + (("seq_res", ("model",)), ("kv_seq", ("model",)),
       ("slots", ("pod", "data")), ("pages", ("pod", "data")))

# Disaggregated decode: batch over data, the cache resident per batch
# shard (no sequence, KV head or latent shard), TP over model.
_SERVE_DECODE_RULES: Rules = (("batch", ("pod", "data")),) + tuple(
    (name, ()) if name in ("embed", "kv_heads", "kv_lora") else (name, targets)
    for name, targets in _WEIGHT_RULES) \
    + (("slots", ("pod", "data")), ("pages", ("pod", "data")))

PRESETS: Dict[str, Rules] = {
    # data-parallel batch + FSDP weights + tensor-parallel contractions
    "baseline": BASE_RULES,
    # Megatron sequence parallelism over the residual-stream anchor
    "sp": BASE_RULES + (("seq_res", ("model",)),),
    # pure data parallelism (weights replicated)
    "ddp": (("batch", ("pod", "data", "model")),),
    # expert parallelism over data + tensor parallelism inside experts
    "ep": _EP_RULES,
    # pod-level FSDP
    "fsdp": _FSDP_RULES,
    # serve-side sequence parallelism
    "serve_sp": _SERVE_SP_RULES,
    # disaggregated decode mesh
    "serve_decode": _SERVE_DECODE_RULES,
}

DEFAULT_RULES = PRESETS["baseline"]


def axis_sizes(mesh) -> Dict[str, int]:
    """name -> size for a ``DeviceMesh``, a ``LocalMesh`` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                        # torch DeviceMesh
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)                      # LocalMesh: a dict already


def _rule_map(rules: Optional[Rules]) -> Dict[str, Tuple[str, ...]]:
    out: Dict[str, Tuple[str, ...]] = {}
    for name, targets in (DEFAULT_RULES if rules is None else rules):
        if targets is None:
            out[name] = ()
        elif isinstance(targets, str):
            out[name] = (targets,)
        else:
            out[name] = tuple(targets)
    return out


def resolve_spec(shape: Sequence[int],
                 logical_axes: Sequence[Optional[str]],
                 mesh, rules: Optional[Rules] = None) -> Spec:
    """Resolve one array's logical axes to a spec on ``mesh``: the
    reference's ``PartitionSpec`` as a tuple."""
    if len(shape) != len(logical_axes):
        raise ValueError(f"rank mismatch: shape {tuple(shape)} vs "
                         f"logical axes {tuple(logical_axes)}")
    rmap = _rule_map(rules)
    sizes = axis_sizes(mesh)
    used: set = set()
    entries: list = []
    for dim, name in zip(shape, logical_axes):
        targets = rmap.get(name, ()) if name is not None else ()
        chosen: list = []
        prod = 1
        for t in targets:
            if t not in sizes or t in used:
                continue
            if dim % (prod * sizes[t]) == 0:
                chosen.append(t)
                prod *= sizes[t]
        used.update(chosen)
        if not chosen:
            entries.append(None)
        elif len(chosen) == 1:
            entries.append(chosen[0])
        else:
            entries.append(tuple(chosen))
    while entries and entries[-1] is None:   # P(a, None) == P(a)
        entries.pop()
    return tuple(entries)


def spec_shard_count(spec: Spec, mesh) -> int:
    """Number of shards a resolved spec splits an array into on ``mesh``
    (per-device size = global size / this)."""
    sizes = axis_sizes(mesh)
    n = 1
    for entry in spec:
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                n *= sizes[ax]
    return n


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` on each mesh dim that shards tensor dim ``d``, else
    ``Replicate()``. Two mesh axes on one dim give ``Shard(d)`` twice,
    which DTensor lays out major to minor in mesh-dim order; a spec entry
    naming them in another order has no such layout and raises. A mesh
    dim of size 1 splits nothing and is ``Replicate()``: DTensor refuses
    to reshape a dim it holds as sharded, even one split in one."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = axis_sizes(mesh)
    names = list(sizes)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a is not None)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} shards dim {d} over "
                             f"mesh axes out of the mesh's order {names}")
        for m in order:
            if sizes[names[m]] > 1:
                out[m] = Shard(d)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One rank's shard shape of a ``shape`` array laid out by ``spec``
    (every resolved dim divides evenly)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                out[d] //= sizes[ax]
    return tuple(out)


def tree_shardings(abs_tree: Any, axes_tree: Any, mesh,
                   rules: Optional[Rules] = None) -> Any:
    """A tree of ``(mesh, placements)`` matching a tree of abstract
    leaves (anything with a ``shape``). ``axes_tree`` mirrors
    ``abs_tree`` with a tuple of logical names at each leaf; the tuples
    are leaves, not subtrees."""
    from repro_torch.models.common import tree_map

    return tree_map(
        lambda leaf, axes: (mesh, placements(
            resolve_spec(leaf.shape, tuple(axes), mesh, rules), mesh)),
        abs_tree, axes_tree)


def distribute_tree(tree: Any, axes_tree: Any, mesh,
                    rules: Optional[Rules] = None) -> Any:
    """Every tensor of ``tree`` as a DTensor laid out by its logical axes.
    Each rank holds the full values and keeps its own shard, moving
    nothing."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.common import tree_map

    return tree_map(
        lambda t, s: distribute_tensor(t, s[0], s[1], src_data_rank=None),
        tree, tree_shardings(tree, axes_tree, mesh, rules))


# ---------------------------------------------------------------------------
# context: activate (mesh, rules) for constrain() / mesh_axis_size()
# ---------------------------------------------------------------------------

class _Stack(threading.local):
    def __init__(self):
        self.items: list = []


_ctx = _Stack()


def _current():
    return _ctx.items[-1] if _ctx.items else None


class axis_rules:
    """``with axis_rules(mesh, rules): ...``: re-entrant and reusable.

    On a ``DeviceMesh`` it also lets DTensor ops read plain tensors (masks,
    positions, scalars) as replicated, DTensor's ``implicit_replication``,
    and restores the previous setting on exit, so that contexts nest. That
    switch is DTensor's own setting, not this module's thread-local
    stack."""

    def __init__(self, mesh, rules: Optional[Rules] = None):
        self.mesh = mesh
        self.rules = DEFAULT_RULES if rules is None else rules
        self._implicit: list = []

    def __enter__(self) -> "axis_rules":
        _ctx.items.append((self.mesh, self.rules))
        if is_device_mesh(self.mesh):
            from torch.distributed.tensor import DTensor

            d = DTensor._op_dispatcher
            self._implicit.append(d._allow_implicit_replication)
            d._allow_implicit_replication = True
        return self

    def __exit__(self, *exc) -> bool:
        _ctx.items.pop()
        if is_device_mesh(self.mesh):
            from torch.distributed.tensor import DTensor

            DTensor._op_dispatcher._allow_implicit_replication = \
                self._implicit.pop()
        return False


def remat_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: the forward runs as it
    is, the recomputation inside the forward's ``axis_rules`` context.
    The autograd engine runs a CUDA backward, and so the recomputation, on
    its device thread, where this thread's context stack is empty."""
    active = _current()
    again = contextlib.nullcontext() if active is None else \
        axis_rules(*active)
    return contextlib.nullcontext(), again


def current_context():
    """The active ``(mesh, rules)``, or ``None`` outside any context."""
    return _current()


def current_mesh():
    """The active context's mesh, or ``None`` outside any context."""
    active = _current()
    return None if active is None else active[0]


def is_device_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` over a process group (not the
    one-process ``LocalMesh`` nor a shape mapping)."""
    return hasattr(mesh, "get_group")


def mesh_axis_size(name: str) -> int:
    """Size of mesh axis ``name`` in the active context (1 outside one)."""
    active = _current()
    if active is None:
        return 1
    mesh, _ = active
    return axis_sizes(mesh).get(name, 1)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor laid out over a mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x, *logical_axes: Optional[str]):
    """``x`` laid out by its logical axes: a DTensor redistributed to the
    resolved placements inside a context; a plain tensor, or anything
    outside a context, unchanged."""
    active = _current()
    if active is None:
        return x
    if not is_dtensor(x):
        return x
    mesh, rules = active
    target = placements(resolve_spec(x.shape, logical_axes, mesh, rules),
                        mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)
