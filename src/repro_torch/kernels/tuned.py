"""Persisted tuned-point cache for the port's kernel registry.

One JSON file (default ``experiments/tuned_torch/kernel_points.json``,
override via ``REPRO_TORCH_TUNED_DIR``) maps ``"<op>|<shape_key>"`` to the
winning block point of a sweep::

    {"version": 1,
     "points": {
       "compact_pack|nsrc1024_nout1024:int32": {
         "device_kind": "NVIDIA H100 80GB HBM3",
         "point": {"block_chunks": 16},
         "objective_us": <the sweep's best time>,
         "evaluations": <points timed>}}}

The directory is the port's own, so its keys never meet the JAX package's
cache. Lookups happen at op-call time (``api.resolve_point``), so they must
be cheap and never wrong-device: the file is memoized per (path, mtime),
and an entry only hits when its recorded ``device_kind`` matches the
running device -- a point written on one card is a clean miss on another
card or on the CPU, falling back to the deterministic default point.
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Any, Dict, Optional

import torch

CACHE_VERSION = 1
_FILENAME = "kernel_points.json"

# memoized payload keyed by (path, mtime_ns) so per-op-call lookups cost
# one stat(), not a JSON parse
_memo: Dict[str, Any] = {"key": None, "points": {}}


def device_kind() -> str:
    if torch.cuda.is_available():
        return torch.cuda.get_device_name()
    return "cpu"


def cache_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_TUNED_DIR")
    if env:
        return pathlib.Path(env)
    # src/repro_torch/kernels/tuned.py -> repo root / experiments / tuned_torch
    return (pathlib.Path(__file__).resolve().parents[3] / "experiments"
            / "tuned_torch")


def cache_path() -> pathlib.Path:
    return cache_dir() / _FILENAME


def invalidate_memo() -> None:
    _memo["key"] = None
    _memo["points"] = {}


def _load_points() -> Dict[str, Any]:
    path = cache_path()
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return {}
    key = (str(path), mtime)
    if _memo["key"] == key:
        return _memo["points"]
    try:
        with open(path) as f:
            payload = json.load(f)
        points = payload.get("points") if isinstance(payload, dict) else None
        points = points if isinstance(points, dict) else {}
    except (OSError, ValueError):
        points = {}
    _memo["key"] = key
    _memo["points"] = points
    return points


def entry_key(op_name: str, shape_key: str) -> str:
    return f"{op_name}|{shape_key}"


def lookup(op_name: str, shape_key: str) -> Optional[Dict[str, Any]]:
    """Tuned point for (op, shape) on THIS device kind, else None."""
    entry = _load_points().get(entry_key(op_name, shape_key))
    if not isinstance(entry, dict):
        return None
    if entry.get("device_kind") != device_kind():
        return None                     # stale-device-kind miss
    point = entry.get("point")
    return dict(point) if isinstance(point, dict) else None


def entry(op_name: str, shape_key: str) -> Optional[Dict[str, Any]]:
    """Full cache record (point + objective + evaluations) regardless of
    device kind -- for reporting, not dispatch."""
    e = _load_points().get(entry_key(op_name, shape_key))
    return dict(e) if isinstance(e, dict) else None


def store(op_name: str, shape_key: str, point: Dict[str, Any],
          objective_us: float, evaluations: int) -> pathlib.Path:
    """Write-through one tuned point (read-modify-write the JSON)."""
    path = cache_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    points = dict(_load_points())
    points[entry_key(op_name, shape_key)] = {
        "device_kind": device_kind(),
        "point": dict(point),
        "objective_us": float(objective_us),
        "evaluations": int(evaluations),
    }
    with open(path, "w") as f:
        json.dump({"version": CACHE_VERSION, "points": points}, f, indent=1,
                  sort_keys=True)
    invalidate_memo()
    return path
