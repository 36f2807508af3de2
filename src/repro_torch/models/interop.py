"""Carry the JAX package's parameters and decode caches into this
package's trees.

``params_from_jax`` takes the reference's ``init_params`` tree as numpy
arrays -- ``jax.tree.map(np.asarray, params)`` -- and returns the port's
tree, leaf for leaf: the layout is the same (stacked ``layers`` leaves,
an xLSTM ``blocks`` list), so this is a pure tensor conversion, and
dtypes are kept. A bfloat16 leaf arrives as an ``ml_dtypes`` array, which
``torch.from_numpy`` rejects; it crosses as its 16 raw bits, so no
``ml_dtypes`` import is needed and the values are bit-equal.

``cache_from_jax`` does the same for a decode cache or a state table
(``jax.tree.map(np.asarray, cache)``): bf16 leaves cross as their raw 16
bits, f8 (e4m3fn) leaves as their raw bytes, int8, int32 and f32 leaves as
they are, so a test can start the port from the reference's exact state
and compare caches bit for bit.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.models.common import is_spec, resolve_device, tree_map
from repro_torch.models.transformer import param_specs


def to_torch(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """One numpy array as a tensor of the same dtype and bits."""
    arr = np.array(arr)                       # owned, writable, contiguous
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    elif arr.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(arr.view(np.uint8)).view(torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def tree_from_numpy(tree: Any, device: torch.device) -> Any:
    return tree_map(lambda a: to_torch(a, device), tree)


def params_from_jax(cfg: ModelConfig, tree: Any, *,
                    device: Union[str, torch.device, None] = None) -> Any:
    """The reference's parameter tree (numpy leaves) as the port's, on
    the card unless ``device`` names another. Raises ``ValueError`` when
    the tree's structure or a leaf's shape is not ``param_specs(cfg)``'s."""
    device = resolve_device(device, "params_from_jax")

    def check(spec, arr):
        if tuple(np.shape(arr)) != tuple(spec.shape):
            raise ValueError(f"params_from_jax: a leaf of shape "
                             f"{np.shape(arr)} where {cfg.name} has "
                             f"{spec.shape}")
        return arr

    tree = tree_map(check, param_specs(cfg), tree, is_leaf=is_spec)
    return tree_from_numpy(tree, device)


def cache_from_jax(tree: Any, *,
                   device: Union[str, torch.device, None] = None) -> Any:
    """The reference's decode cache (numpy leaves, a flat dict or the
    xLSTM ``{"blocks": [...]}``) as the port's, leaf for leaf and bit for
    bit, on the card unless ``device`` names another."""
    return tree_from_numpy(tree, resolve_device(device, "cache_from_jax"))
