"""CDC ingest under AutoComp: one writer in a closed loop flushes small
token shards to a log-structured table through the port's table layer,
one commit a flush; after ``commits_per_table`` commits (AutoComp's
schedule) AutoComp (the launcher's wiring,
``launch.train.build_autocomp``, merging on the card through
``data.packing.merge_shards_fn``) ticks, running cycles until one removes
no file. Then the table is set aside and a new one begun, so host memory
stays bounded; the
window runs whole tables, each started only where it would end inside the
window (``portbench.window``), so every table does the same merges.
Everything lives in the port's ``InMemoryStore``; nothing is written to
disk.

Mix keys: ``shards_per_commit``, ``shard_tokens``, ``pool_shards`` (the
token arrays drawn from the seed in set-up; each commit takes a seeded
choice of them), ``flush_s`` (the table clock's step a commit),
``commits_per_table``, ``max_cycles`` (a bound on the cycles of one tick),
``warm_shards`` and ``limits``.

The check replays every cycle with the plain reference
(``reference.shards``): from the listing the cycle started from, it plans
the bins again (first-fit decreasing at the configuration's target) and
holds the program to them: the files removed and added, each output's
tokens (the pool's arrays of its inputs, in order) and row count, and the
cycle's GBHr.
"""

from __future__ import annotations

from portbench import traffic, window
from reference import shards as ref_shards


class Driver:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.cfg, self.mix, self.rec = ctx.cfg, ctx.mix, ctx.rec
        self.target = int(self.cfg["corpus"]["target_file_bytes"])
        self.tables = []        # per table: committed paths -> pool ids
        self.cycles = []        # per cycle: what the check replays

    def setup(self) -> None:
        from repro_torch.data import packing, shards
        from repro_torch.launch import train as launch_train
        from repro_torch.lst import Catalog, InMemoryStore
        from repro_torch.lst.files import DataFile
        from repro_torch.lst.workload import SimClock

        self.packing, self.shards = packing, shards
        self.launch_train = launch_train
        self.Catalog, self.InMemoryStore = Catalog, InMemoryStore
        self.DataFile, self.SimClock = DataFile, SimClock
        n, t = int(self.mix["pool_shards"]), int(self.mix["shard_tokens"])
        with self.rec.span("pool"):
            gen = traffic.rng(self.ctx.seed, 4)
            self.pool = traffic.tokens(gen, (n, t), self.cfg["vocab_size"])
        self.commits = 0
        # the window's path once, on a scratch table: the kernel's build
        # and first launch, the store and the cycle's code
        with self.rec.span("warm"):
            self.new_table()
            self.commit(int(self.mix["warm_shards"]))
            self.tick()
        self.tables.clear()
        self.cycles.clear()
        self.commits = 0

    def new_table(self) -> None:
        clock = self.SimClock()
        store = self.InMemoryStore()
        catalog = self.Catalog(store, now_fn=clock.now)
        table = catalog.create_table(
            "lake", f"cdc{len(self.tables)}",
            properties={"conflict_granularity":
                        self.cfg["corpus"]["conflict_granularity"]})
        table.now_fn = clock.now
        auto = self.launch_train.build_autocomp(
            catalog, clock, target_bytes=self.target,
            device=self.ctx.device)
        self.table = (catalog, table, store, clock, auto)
        self.prov = {}
        self.tables.append(self.prov)

    def commit(self, n: int) -> int:
        """One flush of ``n`` shards from the pool, encoded and committed
        through the port's table layer; returns its bytes."""
        catalog, table, store, clock, _ = self.table
        gen = traffic.rng(self.ctx.seed, 5, self.commits)
        ids = gen.choice(len(self.pool), n, replace=False)
        files = []
        for j, i in enumerate(ids):
            path = f"{table.table_id}/data/cdc-{self.commits:06d}-{j:04d}.toks"
            raw = self.shards.encode_shard(self.pool[i])
            store.put(path, raw)
            files.append(self.DataFile(path=path, size_bytes=len(raw),
                                       num_rows=int(self.pool.shape[1]),
                                       created_at=clock.now()))
            self.prov[path] = [int(i)]
        table.append(files)
        clock.advance(float(self.mix["flush_s"]))
        self.commits += 1
        return sum(f.size_bytes for f in files)

    def cycle(self) -> int:
        """One AutoComp cycle; records what the check replays. Returns
        the files it removed."""
        catalog, table, store, clock, auto = self.table
        before = [(f.path, f.size_bytes) for f in table.current_files()]
        with self.rec.span("cycle"):
            rep = auto.run_cycle(catalog)
        live = {f.path: f for f in table.current_files()}
        old = {p for p, _ in before}
        added = {p: (store.get(p), live[p].num_rows, live[p].size_bytes)
                 for p in live if p not in old}
        self.cycles.append({"table": len(self.tables) - 1,
                            "before": before, "added": added,
                            "live_after": sorted(live),
                            "gbhr": rep.gbhr})
        self.rec.add("merge_bytes",
                     sum(s for p, s in before if p not in live)
                     + sum(a[2] for a in added.values()))
        clock.advance(0.01)
        return rep.files_removed

    def tick(self) -> None:
        """AutoComp's scheduled run: cycles until one removes no file."""
        for _ in range(int(self.mix["max_cycles"])):
            if self.cycle() == 0:
                break

    def fill_table(self) -> int:
        """One table: its commits, then AutoComp's tick; returns the bytes
        committed."""
        nbytes = 0
        for _ in range(int(self.mix["commits_per_table"])):
            with self.rec.span("commit"):
                nbytes += self.commit(int(self.mix["shards_per_commit"]))
            self.rec.add("attempted", 1)
        self.tick()
        return nbytes

    def run_window(self, seconds: float) -> None:
        self.packing.reset_stage_seconds()
        win = window.Window(seconds)
        ingested = 0
        for _ in win:
            self.new_table()
            ingested += self.fill_table()
        self.elapsed = win.elapsed
        self.ingested = ingested
        self.rec.info["units_s"] = win.units_s
        self.rec.info["stage_seconds"] = dict(self.packing.STAGE_SECONDS)
        self.rec.counters["ingested_bytes"] = ingested

    def end_to_end(self) -> dict:
        return {"compacted_mib_s": self.ingested / 2 ** 20 / self.elapsed}

    def release(self) -> None:
        self.table = None

    def check(self, control: bool = False) -> list:
        corpus = self.cfg["corpus"]
        rep = ref_shards.replay(self.cycles, self.tables, self.pool,
                                self.target, corpus["executor_memory_gb"],
                                corpus["rewrite_bytes_per_hour"])
        lim = self.mix["limits"]
        return [{"name": k, "value": float(rep[k]), "limit": float(lim[k])}
                for k in ("plan_mismatch", "output_mismatch",
                          "gbhr_mismatch")]
