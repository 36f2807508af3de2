"""Multi-prefill-worker fan-in: admission arbitration for one decode slot
table fed by N independent prefill workers.

AutoComp's fleet scheduler (``core/fleet.py``) arbitrates many tables
competing for a shared compaction budget; this module is the serving-side
translation — many prefill workers competing for rows of one decode slot
table. The :class:`AdmissionArbiter` owns the queue discipline:

* **FIFO with priority classes** — requests carry a class (0 = most
  urgent); within a class, enqueue order wins.
* **Aging + hard promotion** — a queued request that loses admission
  passes gains an aging boost (the same ``1 + aging_boost *
  min(skips, n) / n`` shape as the fleet scheduler's starvation
  guarantee), and at ``promotion_cycles`` lost passes it is *hard
  promoted*: sorted ahead of the un-starved pool (oldest first) and
  allowed to evict, so no request waits unboundedly.
* **Per-worker in-flight accounting** — each prefill worker holds at most
  ``max_inflight`` dispatched prefill+transfer jobs (the double buffer of
  ``serve.make_cache_mover``); assignment goes to the least-loaded,
  lowest-numbered worker.
* **Deterministic tie-break** — the admission order is a total order over
  (hard-promoted, urgency, enqueue sequence, request id) with NO
  wall-clock input: the engine admits the arbiter's choice and *blocks*
  on its shipment rather than racing on arrival order, so a permuted
  worker completion order replays the same admission sequence (the NFR2
  replayability property ``tests/test_serve_fanin.py`` pins).

Eviction, when the table is full, is policy-driven
(:data:`EVICTION_POLICIES`): ``"oldest"`` preempts the longest-resident
occupant, ``"priority"`` the worst-class (then longest-resident) one.
Either way an eviction must be *justified* — the pending request outranks
the victim's class or has hit the hard promotion bound — so equal-class
pressure ages in the queue instead of thrashing the table. Evicted
requests re-queue with their prompt extended by the tokens already
emitted (recompute-style preemption; the engine re-prefills and the
greedy continuation bit-matches an uncontended run).

Pure host-side stdlib/numpy — no jax import — so ``serve.fanin_report``
can drive the real arbiter in a deterministic roofline simulation.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence

import numpy as np

EVICTION_POLICIES = ("none", "oldest", "priority")

# Mirrors core/fleet.py's starvation guarantee: the same aging-boost
# factor and the same hard promotion bound, applied to admission passes
# instead of scheduler cycles.
AGING_BOOST = 0.5
PROMOTION_CYCLES = 5


@dataclasses.dataclass
class Request:
    """One generation request moving through the fan-in lifecycle
    (queue -> prefill worker -> arbiter -> slot -> evict/requeue -> free).

    ``rid`` is stable across evictions (the deterministic tie-break of
    last resort); ``prompt`` grows by the emitted tokens on requeue and
    ``max_new`` shrinks by them, so a readmission re-prefills the
    extended prompt and continues exactly where the eviction cut it off.
    """
    rid: int
    prompt: np.ndarray                 # (len,) int32 tokens
    max_new: int
    priority: int = 0                  # class, 0 = most urgent
    # arbiter bookkeeping (owned by AdmissionArbiter)
    seq: int = -1                      # enqueue sequence number
    skips: int = 0                     # admission passes lost while queued
    evictions: int = 0                 # times preempted so far
    worker: int = -1                   # assigned prefill worker, -1 = none


@dataclasses.dataclass(frozen=True)
class Occupant:
    """What the arbiter needs to know about a slot's current resident."""
    rid: int
    priority: int
    admit_seq: int                     # admission sequence number


class AdmissionArbiter:
    """FIFO-with-priority-classes admission queue over N prefill workers.

    The engine drives it in passes: ``assign()`` hands queued requests to
    workers (dispatching their prefill+ship), ``next_admission()`` names
    the one request the pass may admit (the engine blocks on its
    shipment), ``admit()``/``age()`` record the outcome, and
    ``pick_victim()`` arbitrates eviction when the table is full.
    """

    def __init__(self, workers: int = 1, classes: int = 1,
                 aging_boost: float = AGING_BOOST,
                 promotion_cycles: int = PROMOTION_CYCLES,
                 max_inflight: int = 1):
        if workers < 1:
            raise ValueError(f"need at least one prefill worker, got {workers}")
        if classes < 1:
            raise ValueError(f"need at least one priority class, got {classes}")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.workers = workers
        self.classes = classes
        self.aging_boost = aging_boost
        self.promotion_cycles = promotion_cycles
        self.max_inflight = max_inflight
        self.queue: List[Request] = []
        self.inflight = [0] * workers      # per-worker in-flight transfers
        self._enqueue_seq = itertools.count()
        self._admit_seq = itertools.count()
        self.stats = {"submitted": 0, "admissions": 0, "evictions": 0,
                      "requeues": 0, "wait_sum": 0, "max_wait": 0}

    # --- queue discipline --------------------------------------------------
    def submit(self, req: Request, requeue: bool = False) -> Request:
        if not 0 <= req.priority < self.classes:
            raise ValueError(
                f"request {req.rid}: priority {req.priority} outside the "
                f"{self.classes} configured classes")
        req.seq = next(self._enqueue_seq)
        req.skips = 0                      # aging restarts per occupancy
        req.worker = -1
        self.queue.append(req)
        self.stats["requeues" if requeue else "submitted"] += 1
        return req

    def promoted(self, req: Request) -> bool:
        return req.skips >= self.promotion_cycles

    def urgency(self, req: Request) -> float:
        """Class urgency times the fleet-style aging boost, capped at the
        promotion bound."""
        n = self.promotion_cycles
        boost = 1.0 + self.aging_boost * min(req.skips, n) / n
        return (self.classes - req.priority) * boost

    def _key(self, req: Request):
        # hard-promoted first, oldest-first among them; then urgency
        # (descending), enqueue order, rid — a total order with no
        # wall-clock input
        hard = self.promoted(req)
        return (0 if hard else 1, req.seq if hard else 0,
                -self.urgency(req), req.seq, req.rid)

    def ordered(self) -> List[Request]:
        return sorted(self.queue, key=self._key)

    # --- worker assignment -------------------------------------------------
    def assign(self) -> List[Request]:
        """Assign unassigned queued requests to prefill workers in arbiter
        order; each worker carries at most ``max_inflight`` dispatched
        jobs. Returns the newly assigned requests (the engine dispatches
        their prefill+ship on the named worker)."""
        out = []
        for req in self.ordered():
            if req.worker >= 0:
                continue
            w = min(range(self.workers), key=lambda i: (self.inflight[i], i))
            if self.inflight[w] >= self.max_inflight:
                break                      # keep order: never skip ahead
            req.worker = w
            self.inflight[w] += 1
            out.append(req)
        return out

    # --- admission ---------------------------------------------------------
    def next_admission(self) -> Optional[Request]:
        """The best-ordered request with a dispatched shipment. Admission
        order is the arbiter's total order, never shipment-arrival order:
        the engine blocks on the chosen shipment, so a permuted worker
        completion order cannot permute admissions."""
        for req in self.ordered():
            if req.worker >= 0:
                return req
        return None

    def admit(self, req: Request) -> Occupant:
        self.queue.remove(req)
        self.inflight[req.worker] -= 1
        self.stats["admissions"] += 1
        self.stats["wait_sum"] += req.skips
        self.stats["max_wait"] = max(self.stats["max_wait"], req.skips)
        return Occupant(rid=req.rid, priority=req.priority,
                        admit_seq=next(self._admit_seq))

    def age(self) -> None:
        """One admission pass ended with these requests still queued."""
        for req in self.queue:
            req.skips += 1

    # --- eviction ----------------------------------------------------------
    def pick_victim(self, occupants: Sequence[Optional[Occupant]],
                    policy: str, pending: Request) -> Optional[int]:
        """Slot to evict for ``pending`` when the table is full, or None.

        ``"oldest"`` targets the longest-resident occupant, ``"priority"``
        the worst class (longest-resident within it). The eviction only
        happens when ``pending`` outranks the victim's class or has hit
        the hard promotion bound — equal-rank pressure keeps aging in the
        queue, so the table never thrashes, while the promotion bound
        still guarantees every request a slot eventually.
        """
        if policy not in EVICTION_POLICIES:
            raise ValueError(f"unknown eviction policy {policy!r}; "
                             f"expected one of {EVICTION_POLICIES}")
        if policy == "none":
            return None
        cands = [(s, o) for s, o in enumerate(occupants) if o is not None]
        if not cands:
            return None
        if policy == "oldest":
            slot, occ = min(cands, key=lambda so: (so[1].admit_seq, so[0]))
        else:  # "priority"
            slot, occ = min(cands,
                            key=lambda so: (-so[1].priority,
                                            so[1].admit_seq, so[0]))
        if self.promoted(pending) or pending.priority < occ.priority:
            return slot
        return None

    def evicted(self, req: Request) -> None:
        """Record a preemption (the engine re-submits via ``submit(...,
        requeue=True)`` with the extended prompt)."""
        req.evictions += 1
        self.stats["evictions"] += 1
