"""The harness of the port's benchmark: the yardstick that later changes to
the program cannot move. Everything particular to one configuration, one
traffic mix or one per-layer metric sits in a file of its own, found by its
name in ``BENCHMARK.json``:

- ``bench/configs/<config>.json``: the configuration as it is run;
- ``bench/mixes/<traffic>.json``: the traffic's parameters, read by the
  driver that its ``"driver"`` key names (``portbench/drivers/<kind>.py``);
- ``bench/metrics/<metric>.py``: the reader of one per-layer metric.

The program under test is ``repro_torch`` (``src/``); nothing here imports
JAX or the JAX package ``repro``, and ``bench/reference`` imports nothing of
the program.
"""
