"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card it is started on: set-up
(imports, inputs and weights drawn from the seed, warm-up of the cell's own
shapes), a measured window of ``--seconds``, then the check of what the
window produced against the plain references under ``bench/reference``.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last the compared numbers under ``checks``); the
compared numbers also end standard error. Without a CUDA card it exits 2
and prints no result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from portbench import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], T_START))
