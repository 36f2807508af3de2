"""Fault-tolerant training runner.

The port of ``src/repro/train/runner.py``: the same loop, hooks and
recovery, over the port's train step and checkpoints.

Production behaviors implemented (and exercised by tests/examples):
  * checkpoint/restart: periodic async saves; ``run_with_recovery`` restores
    from the latest checkpoint after a (simulated) preemption and continues
    — loss trajectory is continuous across the restart;
  * elastic scaling: restore works under a different microbatching, and
    across ranks onto another mesh (``CheckpointManager.restore`` lays a
    DTensor leaf out as the live one, or by ``shardings=``);
  * straggler mitigation: per-step host timing with a rolling median; steps
    slower than ``straggler_factor`` x median are flagged, and a pluggable
    policy reacts (on a real fleet: evict/replace the slow host; here the
    hook records and the simulated straggler is removed);
  * storage healing: an AutoComp service tick runs between steps (the
    "separate compaction cluster" of §4.4 — host threads, never blocking
    the device step).
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from repro_torch.train.checkpoints import CheckpointManager


class SimulatedPreemption(Exception):
    """Raised by fault-injection hooks to model a node preemption."""


@dataclasses.dataclass
class RunnerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    async_ckpt: bool = True
    straggler_factor: float = 3.0
    straggler_window: int = 16


class Trainer:
    def __init__(self, cfg: RunnerConfig, train_step: Callable,
                 params: Any, opt_state: Any,
                 batches: Callable[[], Iterator[Dict[str, np.ndarray]]],
                 ckpt: Optional[CheckpointManager] = None,
                 autocomp_tick: Optional[Callable[[], Any]] = None,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 straggler_hook: Optional[Callable[[int, float], float]] = None,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None
                 ) -> None:
        self.cfg = cfg
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.batches = batches
        self.ckpt = ckpt
        self.autocomp_tick = autocomp_tick
        self.fault_hook = fault_hook
        self.straggler_hook = straggler_hook
        self.on_straggler = on_straggler
        self.history: List[Dict[str, float]] = []
        self.step = 0
        self.restarts = 0
        self.stragglers_detected: List[int] = []

    # ------------------------------------------------------------------ run
    def _maybe_restore(self) -> None:
        if self.ckpt is None:
            return
        try:
            (self.params, self.opt_state, step), s = self.ckpt.restore(
                (self.params, self.opt_state, 0))
            self.step = int(step)
        except FileNotFoundError:
            pass

    def _save(self, blocking: bool = False) -> None:
        if self.ckpt is None:
            return
        self.ckpt.save(self.step, (self.params, self.opt_state, self.step),
                       blocking=blocking or not self.cfg.async_ckpt)

    def run(self) -> Dict[str, Any]:
        it = self.batches()
        step_times: List[float] = []
        while self.step < self.cfg.total_steps:
            try:
                batch = next(it)
            except StopIteration:
                it = self.batches()
                batch = next(it)
            if self.fault_hook is not None:
                self.fault_hook(self.step)          # may raise preemption
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if self.straggler_hook is not None:
                dt += self.straggler_hook(self.step, dt)  # injected delay
            step_times.append(dt)
            if len(step_times) >= self.cfg.straggler_window:
                med = statistics.median(step_times[-self.cfg.straggler_window:])
                if dt > self.cfg.straggler_factor * med:
                    self.stragglers_detected.append(self.step)
                    if self.on_straggler is not None:
                        self.on_straggler(self.step, dt, med)
            self.history.append({"step": self.step, "loss": loss,
                                 "time_s": dt})
            self.step += 1
            if self.ckpt is not None and self.step % self.cfg.ckpt_every == 0:
                self._save()
            if self.autocomp_tick is not None:
                self.autocomp_tick()
        if self.ckpt is not None:
            self._save(blocking=True)
            self.ckpt.wait()
        return {"final_step": self.step, "history": self.history,
                "stragglers": self.stragglers_detected}

    def run_with_recovery(self, max_restarts: int = 3) -> Dict[str, Any]:
        """Preemption-tolerant outer loop: restore + continue on failure."""
        while True:
            try:
                return self.run()
            except SimulatedPreemption:
                self.restarts += 1
                if self.restarts > max_restarts:
                    raise
                if self.ckpt is not None:
                    self.ckpt.wait()
                self._maybe_restore()
