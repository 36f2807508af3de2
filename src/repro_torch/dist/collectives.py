"""Serve-time scopes of the collectives, on one device.

Training runs outside every serve scope, so the model code sees what the
JAX package's sees there (``src/repro/dist/collectives.py``): no
activation transport, a bf16 decode cache, and an activation all-gather
that is the identity. The int8 and f8 quantizers come with serving.
"""

from __future__ import annotations

from typing import Optional


def current_act_transport() -> Optional[str]:
    """Active serve activation transport: None, as outside any scope."""
    return None


def current_kv_storage() -> str:
    """Active decode-cache storage dtype: ``"bf16"``, the default."""
    return "bf16"


def act_gather(x, *logical_axes: Optional[str]):
    """The serve activation all-gather: the identity outside a transport
    scope, which is everywhere on one device."""
    return x
