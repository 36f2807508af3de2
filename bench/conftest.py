"""Puts the harness (``bench/``) and the program (``src/``) on the path of
the benchmark's own tests, which run on the host at smoke sizes."""

import pathlib
import sys

_BENCH = pathlib.Path(__file__).resolve().parent
for _p in (_BENCH, _BENCH.parent / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))
