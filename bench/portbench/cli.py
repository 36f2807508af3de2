"""The command line and the run of one cell: set-up, the measured window,
the metrics, then the check of what the window produced."""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from typing import Any, Dict, Optional

from portbench import registry
from portbench.records import Records, Trace

# top-level module names that may not be loaded in a run (whole names:
# the program ``repro_torch`` is allowed, the JAX package ``repro`` not)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the drivers' spans inside set-up that the run reports apart
SETUP_PHASES = ("weights", "pool", "warm")


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


class Context:
    """What a driver is handed: where to run, the seed, the configuration
    and traffic as data, and the records to fill."""

    def __init__(self, device, seed: int, cfg: Dict[str, Any],
                 mix: Dict[str, Any], rec: Records, cell: Dict[str, Any]):
        self.device, self.seed = device, seed
        self.cfg, self.mix, self.rec, self.cell = cfg, mix, rec, cell


def sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def _merge(base: Dict[str, Any], over: Optional[Dict[str, Any]]):
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) \
            and isinstance(out.get(k), dict) else v
    return out


def run_cell(bench: Dict[str, Any], cell: Dict[str, Any], seed: int,
             seconds: float, trace: bool, device, t_start: float,
             overrides: Optional[Dict[str, Any]] = None,
             control: bool = False) -> Dict[str, Any]:
    """One run of ``cell`` on ``device``. ``overrides`` (``{"config":
    {...}, "mix": {...}}``) shrink a cell for the tests on the host, and
    ``control`` adds the control's reading to each check (for
    ``calibrate.py``); the command line passes neither."""
    import torch

    t_enter = time.perf_counter()
    overrides = overrides or {}
    cfg = _merge(registry.config(cell["config"]), overrides.get("config"))
    mix = _merge(registry.mix(cell["traffic"]), overrides.get("mix"))
    rec = Records(tracing=trace)
    ctx = Context(device, seed, cfg, mix, rec, cell)
    drv = registry.driver(mix["driver"]).Driver(ctx)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)           # the context, before reset
        torch.cuda.reset_peak_memory_stats(device)
    t_setup = time.perf_counter()
    drv.setup()
    sync(device)
    t_end = time.perf_counter()
    setup_s = t_end - t_start
    # set-up by phase: what varies from run to run
    phases = {"imports": t_enter - t_start, "context": t_setup - t_enter}
    phases.update({k: rec.seconds(k) for k in SETUP_PHASES if k in rec.spans})
    phases["other"] = t_end - t_setup - sum(
        v for k, v in phases.items() if k in SETUP_PHASES)
    print("setup phases: " + ", ".join(f"{k} {v:.3f} s"
                                       for k, v in phases.items()),
          file=sys.stderr)
    rec.spans.clear()
    rec.counters.clear()
    rec.notes.clear()

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if device.type == "cuda" \
            else [ProfilerActivity.CPU]
        prof = profile(activities=acts)
        prof.__enter__()
    with rec.span("window"):
        t0 = time.perf_counter()
        drv.run_window(seconds)
        sync(device)
        rec.window = (t0, time.perf_counter())
    unit_s = rec.info.get("units_s", [])
    print(f"window: {rec.window_s:.3f} s, {len(unit_s)} whole units of "
          + " ".join(f"{u:.3f}" for u in unit_s) + " s", file=sys.stderr)
    if prof is not None:
        t1 = time.perf_counter()
        prof.__exit__(None, None, None)
        rec.trace = Trace.from_profiler(prof, rec)
        del prof
        lo, hi = rec.trace.window
        inside = sum(1 for _, _, a, b in rec.trace.ops if a >= lo and b <= hi)
        print(f"trace: {len(rec.trace.ops)} device operations, {inside} "
              f"inside the window; read in {time.perf_counter() - t1:.1f} s",
              file=sys.stderr)

    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    rec.counters["memory_peak_bytes"] = peak
    e2e = drv.end_to_end()
    e2e["setup_s"] = setup_s
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    metrics: Dict[str, Any] = {}
    if trace:
        for m in registry.per_layer(bench, cell["name"]):
            v = registry.metric_reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        for m in registry.end_to_end(bench, cell["name"]):
            metrics[m["name"]] = {"value": e2e[m["name"]],
                                  "unit": units[m["name"]]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "host",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out: Dict[str, Any] = {"correct": False,
                           "attempted": int(rec.counters.get("attempted", 0)),
                           "failed": int(rec.counters.get("failed", 0)),
                           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = rec.trace.busy_s()
        dev["window_s"] = rec.trace.window_s()
        out["breakdown"] = rec.trace.breakdown(rec.spans)
        rec.trace = None

    # the check, once the program's state is freed
    drv.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check(control=control)
    ok = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks) and out["failed"] == 0 and out["attempted"] > 0
    out["correct"] = ok
    out["setup_phases"] = phases
    out["checks"] = {c["name"]: {k: c[k] for k in ("value", "limit",
                                                    "control") if k in c}
                     for c in checks}
    out["_e2e"] = e2e
    return out


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    if not (registry.SRC / "repro_torch").is_dir():
        print(f"the program (src/repro_torch) is not in this checkout: "
              f"{registry.ROOT}", file=sys.stderr)
        return 2
    registry.prepare_env()
    import torch

    bench = registry.benchmark()
    cell = registry.cell(args.workload, bench)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"cuda available: {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    res = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    res.pop("_e2e")
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
