"""Logical-axis sharding on one device: no mesh, so no constraint.

``constrain`` is the JAX package's with no active ``axis_rules`` context
(``src/repro/dist/sharding.py``: it returns ``x``), and ``mesh_axis_size``
reads 1 for every axis, as it does there outside a context. The logical
axis names stay at every call site so the multi-GPU slice can resolve them
onto a ``DeviceMesh``.
"""

from __future__ import annotations

from typing import Optional


def constrain(x, *logical_axes: Optional[str]):
    """Annotate ``x`` with its logical axes: the identity on one device."""
    return x


def mesh_axis_size(name: str) -> int:
    """Size of mesh axis ``name``: 1, since there is no mesh."""
    return 1
