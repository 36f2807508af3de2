"""Readings for the limits of a cell's check: the program's and the
control's numbers over many seeds in one process.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 10

For each seed, one run of the cell (set-up, a short window at the cell's
own load, the check) prints a JSON line with its end-to-end metrics, each
compared number and the control's reading of it (the plain reference in
the nearest precision below the configuration's: float8 e4m3 operands
for a bfloat16 model). The benchmark's own runs never run the control.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from portbench import cli, faults, registry  # noqa: E402


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--plant", default="none",
                    help="a fault of portbench.faults planted underneath")
    args = ap.parse_args(argv)
    registry.prepare_env()
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    bench = registry.benchmark()
    cell = registry.cell(args.workload, bench)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        with faults.plant(args.plant):
            out = cli.run_cell(bench, cell, seed, args.seconds, False,
                               torch.device("cuda", 0), t,
                               control=bool(args.control))
        print(json.dumps({"seed": seed, "plant": args.plant,
                          "e2e": out["_e2e"],
                          "attempted": out["attempted"],
                          "correct": out["correct"],
                          "checks": out["checks"],
                          "wall_s": time.perf_counter() - t}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
