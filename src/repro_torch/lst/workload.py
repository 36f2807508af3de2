"""CAB-like synthetic workload generator (§6 "Design of Experimental
Workloads"): query streams modeled after cloud warehouse usage — constant
demand with sinusoidal variation (dashboards), short bursts (interactive),
large bursts (daily maintenance), and predictable hourly jobs — driving
writes into partitioned (LINEITEM-like) and unpartitioned (ORDERS-like)
tables. Deterministic under a seed (NFR2 makes the whole pipeline
reproducible end-to-end).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.lst.catalog import Catalog
from repro_torch.lst.files import DataFile
from repro_torch.lst.table import CommitConflict, LogStructuredTable

MB = 1 << 20


class SimClock:
    """Logical time in hours (float)."""

    def __init__(self, start: float = 0.0) -> None:
        self.t = start

    def now(self) -> float:
        return self.t

    def advance(self, hours: float) -> None:
        self.t += hours


@dataclasses.dataclass
class StreamSpec:
    kind: str          # "dashboard" | "interactive" | "maintenance" | "hourly"
    table: str
    namespace: str
    reads_per_hour: float = 4.0
    writes_per_hour: float = 1.0
    files_per_write: Tuple[int, int] = (4, 40)       # min,max small files
    file_size_mb: Tuple[float, float] = (0.5, 32.0)  # lognormal-ish range


@dataclasses.dataclass
class WorkloadSpec:
    n_databases: int = 4
    tables_per_db: int = 4
    partitions_per_table: int = 12        # monthly SHIPDATE granularity
    partitioned_fraction: float = 0.5
    target_file_mb: int = 512
    initial_files_per_table: Tuple[int, int] = (50, 400)
    seed: int = 0


@dataclasses.dataclass
class FleetSpec:
    """High-rate fleet workload (Arc's small-file storm, scaled): thousands
    of tables with a class mix — a storm fraction ingesting tens of small
    files per write at a high write rate (Arc measured ~17k files/day per
    measurement; ``storm_writes_per_hour * mean(storm_files_per_write)``
    sets the scaled-down equivalent), a bursty interactive fraction, a cold
    long tail, and steady dashboard tables for the rest."""
    n_tables: int = 2000
    tables_per_db: int = 50
    storm_fraction: float = 0.15
    bursty_fraction: float = 0.2
    cold_fraction: float = 0.3
    partitioned_fraction: float = 0.5
    partitions_per_table: int = 12
    target_file_mb: int = 512
    initial_files_per_table: Tuple[int, int] = (4, 24)
    storm_files_per_write: Tuple[int, int] = (20, 60)
    storm_writes_per_hour: float = 6.0
    seed: int = 0
    # retention scenario knobs (only read when the bench enables retention):
    # a standing TTL dropping files older than this many sim-hours, and a
    # one-shot GDPR-style predicate delete over every Nth table dropping
    # ~selectivity of its rows
    retention_max_age_hours: float = 2.0
    gdpr_table_stride: int = 7
    gdpr_selectivity: float = 0.05


@dataclasses.dataclass
class QueryEvent:
    t: float
    kind: str            # "read" | "write"
    table_id: str
    latency: float = 0.0
    files_scanned: int = 0
    files_written: int = 0
    conflict: bool = False
    retries: int = 0


class ActivityTracker:
    """Aggregates :class:`QueryEvent` streams into per-table read/write
    rates over a sliding window of logical time — the bridge between the
    workload and the observe phase (``StatsCollector(activity=...)``).

    The fleet scheduler consumes these rates twice: query frequency weights
    compaction benefit (a hot table's small files hurt every read), and the
    write pattern (file rate + burstiness) drives workload classification
    (append-storm / bursty / cold / steady).
    """

    def __init__(self, now_fn, window_hours: float = 24.0) -> None:
        self.now_fn = now_fn
        self.window = window_hours
        # table_id -> list of (t, kind, n_files) pruned to the window
        self._events: Dict[str, List[Tuple[float, str, int]]] = {}

    def record(self, events: Sequence[QueryEvent]) -> None:
        for ev in events:
            self._events.setdefault(ev.table_id, []).append(
                (ev.t, ev.kind, ev.files_written if ev.kind == "write"
                 else ev.files_scanned))
        self._prune()

    def _prune(self) -> None:
        cutoff = self.now_fn() - self.window
        for tid, evs in self._events.items():
            if evs and evs[0][0] < cutoff:
                self._events[tid] = [e for e in evs if e[0] >= cutoff]

    def _span_hours(self, evs: List[Tuple[float, str, int]]) -> float:
        # rate denominator: observed span inside the window, >= 1h so a
        # single fresh event never reads as an infinite rate
        if not evs:
            return 1.0
        return max(1.0, self.now_fn() - min(e[0] for e in evs))

    def read_rate(self, table_id: str) -> float:
        """Reads per hour over the window (the query frequency weight)."""
        evs = self._events.get(table_id, [])
        return sum(1 for e in evs if e[1] == "read") / self._span_hours(evs)

    def write_rate(self, table_id: str) -> float:
        evs = self._events.get(table_id, [])
        return sum(1 for e in evs if e[1] == "write") / self._span_hours(evs)

    def write_file_rate(self, table_id: str) -> float:
        """Small files landed per hour — the append-storm signature."""
        evs = self._events.get(table_id, [])
        return sum(e[2] for e in evs if e[1] == "write") \
            / self._span_hours(evs)

    def burstiness(self, table_id: str) -> float:
        """Peak-to-mean ratio of per-hour write counts (1.0 = steady)."""
        evs = [e for e in self._events.get(table_id, []) if e[1] == "write"]
        if not evs:
            return 0.0
        per_hour: Dict[int, int] = {}
        for t, _, _ in evs:
            per_hour[int(t)] = per_hour.get(int(t), 0) + 1
        span = max(1, int(self._span_hours(evs)))
        mean = len(evs) / span
        return max(per_hour.values()) / mean if mean > 0 else 0.0


class CostModel:
    """Client-visible latency model: planning scales with file count (RPC
    pressure), execution with bytes and per-file open overhead — the
    mechanism behind Fig. 3/Fig. 8."""

    def __init__(self, open_ms: float = 4.0, plan_ms_per_file: float = 0.8,
                 read_gb_per_s: float = 1.0, base_ms: float = 50.0):
        self.open_ms = open_ms
        self.plan_ms_per_file = plan_ms_per_file
        self.read_gb_per_s = read_gb_per_s
        self.base_ms = base_ms

    def read_latency_s(self, files: Sequence[DataFile]) -> float:
        n = len(files)
        byts = sum(f.size_bytes for f in files)
        return (self.base_ms + n * (self.open_ms + self.plan_ms_per_file)
                ) / 1e3 + byts / (self.read_gb_per_s * 1e9)


class WorkloadGenerator:
    def __init__(self, catalog: Catalog, spec: WorkloadSpec,
                 clock: Optional[SimClock] = None,
                 cost: Optional[CostModel] = None) -> None:
        self.catalog = catalog
        self.spec = spec
        self.clock = clock or SimClock()
        self.cost = cost or CostModel()
        self.rng = np.random.RandomState(spec.seed)
        self.streams: List[StreamSpec] = []
        self.events: List[QueryEvent] = []
        self._file_ids = itertools.count(1)

    # -------------------------------------------------------------- setup
    def setup(self) -> None:
        kinds = ["dashboard", "interactive", "maintenance", "hourly"]
        for d in range(self.spec.n_databases):
            ns = f"db{d:02d}"
            self.catalog.create_namespace(ns, total_quota=200_000)
            for t in range(self.spec.tables_per_db):
                partitioned = self.rng.rand() < self.spec.partitioned_fraction
                name = f"table{t:02d}"
                table = self.catalog.create_table(
                    ns, name, "ship_month" if partitioned else None,
                    properties={"conflict_granularity": "table"})
                table.now_fn = self.clock.now
                n0 = self.rng.randint(*self.spec.initial_files_per_table)
                self._append_small_files(table, n0)
                self.streams.append(StreamSpec(
                    kind=kinds[t % len(kinds)], table=name, namespace=ns,
                    reads_per_hour=float(self.rng.randint(2, 12)),
                    writes_per_hour=float(self.rng.randint(1, 6))))

    def setup_fleet(self, fspec: FleetSpec) -> None:
        """Create a fleet of ``n_tables`` with a deterministic class mix.
        Stream kinds: ``append_storm`` (high-rate small-file ingestion),
        ``interactive`` (bursty), ``cold`` (near-idle long tail),
        ``dashboard`` (steady) — the observed write/query patterns the
        fleet scheduler classifies tables by."""
        self.spec = WorkloadSpec(
            n_databases=max(1, -(-fspec.n_tables // fspec.tables_per_db)),
            tables_per_db=fspec.tables_per_db,
            partitions_per_table=fspec.partitions_per_table,
            partitioned_fraction=fspec.partitioned_fraction,
            target_file_mb=fspec.target_file_mb,
            initial_files_per_table=fspec.initial_files_per_table,
            seed=fspec.seed)
        self.rng = np.random.RandomState(fspec.seed)
        n = fspec.n_tables
        n_storm = int(round(n * fspec.storm_fraction))
        n_bursty = int(round(n * fspec.bursty_fraction))
        n_cold = int(round(n * fspec.cold_fraction))
        kinds = (["append_storm"] * n_storm + ["interactive"] * n_bursty
                 + ["cold"] * n_cold)
        kinds += ["dashboard"] * (n - len(kinds))
        self.rng.shuffle(kinds)             # seeded: deterministic mixing
        made = 0
        for d in range(self.spec.n_databases):
            ns = f"db{d:03d}"
            self.catalog.create_namespace(ns, total_quota=500_000)
            for t in range(self.spec.tables_per_db):
                if made >= n:
                    break
                kind = kinds[made]
                partitioned = self.rng.rand() < fspec.partitioned_fraction
                name = f"table{t:03d}"
                table = self.catalog.create_table(
                    ns, name, "ship_month" if partitioned else None,
                    properties={"conflict_granularity": "table"})
                table.now_fn = self.clock.now
                n0 = self.rng.randint(*fspec.initial_files_per_table)
                self._append_small_files(table, n0)
                if kind == "append_storm":
                    st = StreamSpec(kind=kind, table=name, namespace=ns,
                                    reads_per_hour=2.0,
                                    writes_per_hour=fspec.storm_writes_per_hour,
                                    files_per_write=fspec.storm_files_per_write)
                elif kind == "interactive":
                    st = StreamSpec(kind=kind, table=name, namespace=ns,
                                    reads_per_hour=6.0, writes_per_hour=2.0)
                elif kind == "cold":
                    st = StreamSpec(kind=kind, table=name, namespace=ns,
                                    reads_per_hour=0.2, writes_per_hour=0.1,
                                    files_per_write=(1, 4))
                else:
                    st = StreamSpec(kind=kind, table=name, namespace=ns,
                                    reads_per_hour=6.0, writes_per_hour=1.0)
                self.streams.append(st)
                made += 1

    def _rand_partition(self, table: LogStructuredTable) -> Optional[str]:
        if not table.meta.partition_spec:
            return None
        return f"m{self.rng.randint(self.spec.partitions_per_table):02d}"

    def _small_file(self, table: LogStructuredTable,
                    partition: Optional[str]) -> DataFile:
        lo, hi = 0.5, 32.0
        size = float(np.exp(self.rng.uniform(np.log(lo), np.log(hi)))) * MB
        fid = next(self._file_ids)
        path = f"{table.table_id}/data/part-{fid:08d}.parquet"
        table.store.put(path, b"x" * min(int(size) // (1 << 14) + 1, 4096))
        return DataFile(path=path, size_bytes=int(size),
                        num_rows=int(size // 200), partition=partition,
                        created_at=self.clock.now())

    def _append_small_files(self, table: LogStructuredTable, n: int) -> int:
        files = [self._small_file(table, self._rand_partition(table))
                 for _ in range(n)]
        before = table.cas_retries
        table.append(files)
        self.catalog.notify_write(table)
        return table.cas_retries - before

    def _prepare_append(self, table: LogStructuredTable, n: int):
        """Open an append transaction (committed later — concurrent writers
        on the same table then collide on the version CAS, the paper's
        client-side conflicts)."""
        files = [self._small_file(table, self._rand_partition(table))
                 for _ in range(n)]
        return table.new_transaction().append_files(files)

    # -------------------------------------------------------------- phases
    def _intensity(self, stream: StreamSpec, hour: float) -> float:
        if stream.kind == "dashboard":     # sinusoidal constant demand
            return 1.0 + 0.5 * math.sin(2 * math.pi * hour / 24.0)
        if stream.kind == "interactive":   # short random bursts
            return 3.0 if self.rng.rand() < 0.2 else 0.3
        if stream.kind == "maintenance":   # large daily burst around hour 4
            return 6.0 if int(hour) % 24 == 4 else 0.1
        if stream.kind == "append_storm":  # sustained high-rate ingestion
            return 1.0
        if stream.kind == "cold":          # near-idle long tail
            return 1.0
        return 1.0 if abs(hour - round(hour)) < 0.26 else 0.0   # hourly job

    def run_hour(self, substeps: int = 4) -> List[QueryEvent]:
        """Advance one logical hour of mixed reads/writes. Writes within a
        substep run as CONCURRENT transactions (opened first, committed
        together), so same-table writers collide on the version CAS."""
        out: List[QueryEvent] = []
        for _ in range(substeps):
            self.clock.advance(1.0 / substeps)
            pending = []                      # (table, txn, event)
            for st in self.streams:
                table = self.catalog.get_table(st.namespace, st.table)
                inten = self._intensity(st, self.clock.now())
                n_reads = self.rng.poisson(st.reads_per_hour * inten / substeps)
                n_writes = self.rng.poisson(st.writes_per_hour * inten / substeps)
                for _ in range(n_reads):
                    part = self._rand_partition(table)
                    files = table.scan(partition=part)
                    # execute the read: one open() RPC per data file (the
                    # HDFS pressure that Fig. 11b measures)
                    for f in files:
                        if table.store.exists(f.path):
                            table.store.metrics.open_calls += 1
                    ev = QueryEvent(self.clock.now(), "read", table.table_id,
                                    latency=self.cost.read_latency_s(files),
                                    files_scanned=len(files))
                    out.append(ev)
                for _ in range(n_writes):
                    n_files = self.rng.randint(*st.files_per_write)
                    txn = self._prepare_append(table, n_files)
                    ev = QueryEvent(self.clock.now(), "write", table.table_id,
                                    files_written=n_files)
                    pending.append((table, txn, ev))
                    out.append(ev)
            for table, txn, ev in pending:    # concurrent commit wave
                before = table.cas_retries
                txn.commit()
                self.catalog.notify_write(table)
                ev.retries = table.cas_retries - before
                ev.conflict = ev.retries > 0
        self.events.extend(out)
        return out

    # -------------------------------------------------------------- metrics
    def total_file_count(self) -> int:
        return sum(t.file_count() for t in self.catalog.tables())

    def small_file_fraction(self, target_bytes: int) -> float:
        files = [f for t in self.catalog.tables() for f in t.current_files()]
        if not files:
            return 0.0
        return sum(1 for f in files if f.size_bytes < target_bytes) / len(files)
