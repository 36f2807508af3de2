"""Finds a cell's configuration, traffic mix, driver and per-layer metric
readers by the names ``BENCHMARK.json`` gives them."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import pathlib
import sys
from typing import Any, Dict, List

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SRC = ROOT / "src"
CACHE = ROOT / "build" / "bench_cache"


def prepare_env() -> None:
    """Puts the program on ``sys.path`` and pins every build and kernel
    cache to a fixed directory inside the checkout, so that only a
    checkout's first run builds."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def benchmark() -> Dict[str, Any]:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name: str, bench: Dict[str, Any] = None) -> Dict[str, Any]:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def _json(kind: str, name: str) -> Dict[str, Any]:
    path = BENCH / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def config(name: str) -> Dict[str, Any]:
    return _json("configs", name)


def mix(name: str) -> Dict[str, Any]:
    return _json("mixes", name)


def driver(kind: str):
    """The driver module of a traffic mix's ``"driver"`` kind."""
    return importlib.import_module(f"portbench.drivers.{kind}")


def metric_reader(name: str):
    """The module ``bench/metrics/<name>.py`` (its ``read(rec)``); the
    readers share ``bench/metrics/_work.py``."""
    metrics = BENCH / "metrics"
    if str(metrics) not in sys.path:
        sys.path.insert(0, str(metrics))
    path = metrics / f"{name}.py"
    mod_name = "portbench_metric_" + name.replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def end_to_end(bench: Dict[str, Any], cell_name: str) -> List[Dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(bench: Dict[str, Any], cell_name: str) -> List[Dict]:
    """The per-layer metrics read in this cell: those that list it."""
    return [m for m in bench["per_layer"] if cell_name in m["workloads"]]
