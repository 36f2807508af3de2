"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

The port of ``src/repro/launch/train.py``, wired as the reference wires
it: config -> model -> train step -> AutoComp-managed data pipeline ->
fault-tolerant Trainer, with an AutoComp cycle over the token-shard
table every ``--compact-every`` steps, merging through
``merge_shards_fn`` (the ``compact_chunks`` kernel on the card), and
checkpoints on the same object store. It runs on the card; ``--device
cpu`` runs it on the host. Three departures from the reference: the
weights are the port's ``init_params(cfg, seed=0)``, not
``jax.random``'s; ``--device`` picks where it runs; and ``main`` takes an
argument list and returns the Trainer's result with the wiring
(``build``, which a caller can also run with a ``fault_hook``).

Across ranks (``torchrun --nproc-per-node 4 -m repro_torch.launch.train``,
or ``main`` called in each rank of an initialised group) it is the
reference's single controller spread over the ranks: rank 0 holds the one
data pipeline, the one AutoComp and the store, and sends each step's
global batch, the one-process launcher's, to every rank, which trains on
its rows; the step is the SPMD step on ``make_local_mesh()`` under the
``baseline`` rules; checkpoints are written once, by rank 0; and only
rank 0 prints. The backend is NCCL when every rank has a card of its
own, gloo otherwise (``mesh.pick_backend``).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, smoke_config
from repro_torch.core import (AutoCompPipeline, MoopRanker, StatsCollector,
                              TraitContext)
from repro_torch.core.act import Scheduler
from repro_torch.core.model import Scope
from repro_torch.core.orient import (ComputeCostTrait,
                                     FileCountReductionTrait,
                                     FileEntropyTrait)
from repro_torch.data import DataPipeline, TokenShardWriter, merge_shards_fn
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import init_ranks, make_local_mesh, pick_backend
from repro_torch.lst import Catalog, InMemoryStore
from repro_torch.lst.workload import SimClock
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib
from repro_torch.train.checkpoints import CheckpointManager
from repro_torch.train.runner import RunnerConfig, Trainer


def build_data(cfg, *, batch, seq_len, n_trickle=30, files_per=15,
               tokens_per_file=4096, seed=0, device="cuda"):
    clock = SimClock()
    store = InMemoryStore()
    catalog = Catalog(store, now_fn=clock.now)
    table = catalog.create_table("train", "corpus",
                                 properties={"conflict_granularity": "table"})
    table.now_fn = clock.now
    writer = TokenShardWriter(table, vocab=cfg.vocab, seed=seed)
    for _ in range(n_trickle):
        writer.trickle_append(files_per, tokens_per_file)
        clock.advance(0.02)
    pipe = DataPipeline(table, batch=batch, seq_len=seq_len, seed=seed,
                        device=device)
    return catalog, table, pipe, clock, store


def build_autocomp(catalog, clock, target_bytes=1 << 22, top_k=4,
                   device="cuda"):
    merge_fn = functools.partial(merge_shards_fn, device=device)
    pipeline = AutoCompPipeline(
        stats=StatsCollector(target_bytes),
        traits=(FileCountReductionTrait(), FileEntropyTrait(),
                ComputeCostTrait()),
        trait_ctx=TraitContext(target_file_bytes=target_bytes),
        ranker=MoopRanker({"file_count_reduction": 0.7, "compute_cost": 0.3}),
        scheduler=Scheduler(target_bytes, merge_fn=merge_fn),
        scope=Scope.TABLE, top_k=top_k)
    return pipeline


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-lm-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config of the arch family")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--grad-transport", default="bf16",
                    choices=step_lib.GRAD_TRANSPORTS,
                    help="int8_ef = blockwise int8 + error feedback on the "
                         "gradient reduction (residual in optimizer state)")
    ap.add_argument("--compact-every", type=int, default=25)
    ap.add_argument("--device", default="cuda",
                    help="where the model, the batches and the compaction "
                         "merge run; 'cpu' runs the kernels' plain versions")
    return ap.parse_args(argv)


@dataclasses.dataclass
class Launch:
    """A launcher's wiring, built and not yet run. Across ranks ``table``,
    ``pipe`` and ``store`` are rank 0's and ``None`` elsewhere."""
    cfg: Any
    mesh: Any
    table: Any
    pipe: Optional[DataPipeline]
    store: Optional[InMemoryStore]
    trainer: Trainer


def ranked_batches(pipe: Optional[DataPipeline], batch: int, seq_len: int,
                   device: torch.device
                   ) -> Callable[[], Iterator[Dict[str, torch.Tensor]]]:
    """A batch factory for every rank: rank 0 draws each global batch from
    ``pipe`` and broadcasts it; the others receive it. A flag sent first
    ends every rank's stream where rank 0's ends."""
    def factory():
        it = pipe.prefetching_batches() if pipe is not None else None
        head = torch.zeros(1, dtype=torch.int32, device=device)
        while True:
            b = next(it, None) if it is not None else None
            head.fill_(0 if (it is not None and b is None) else 1)
            collectives.broadcast(head)
            if int(head.item()) == 0:
                return
            if b is None:
                b = {k: torch.empty((batch, seq_len), dtype=torch.int32,
                                    device=device)
                     for k in ("tokens", "labels")}
            yield {k: collectives.broadcast(b[k]) for k in
                   ("tokens", "labels")}
    return factory


def build(args: argparse.Namespace,
          fault_hook: Optional[Callable[[int], None]] = None) -> Launch:
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = make_local_mesh(device=args.device)
    ranked = collectives.ranked()
    rank0 = not ranked or dist.get_rank() == 0
    device = torch.device(args.device)
    if device.type == "cuda" and ranked:
        device = torch.device("cuda", torch.cuda.current_device())
    catalog = table = pipe = clock = None
    store = InMemoryStore()
    if rank0:
        catalog, table, pipe, clock, store = build_data(
            cfg, batch=args.batch, seq_len=args.seq_len, device=device)
    rules = shd.PRESETS["baseline"]
    params = transformer.init_params(cfg, seed=0, device=device)
    batches = pipe.prefetching_batches if pipe is not None else None
    if ranked:
        params = shd.distribute_tree(params, transformer.param_axes(cfg),
                                     mesh, rules)
        batches = ranked_batches(pipe, args.batch, args.seq_len, device)
    opt_state = opt_lib.init_state(
        params, error_feedback=args.grad_transport == "int8_ef")
    adamw = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=10,
                                total_steps=args.steps)
    with shd.axis_rules(mesh, rules):
        step_fn = step_lib.make_train_step(
            cfg, adamw, microbatches=args.microbatches,
            grad_transport=args.grad_transport)

    ckpt = CheckpointManager(store, keep_last=2)
    tick = None
    if rank0:
        autocomp = build_autocomp(catalog, clock, device=device)
        state = {"i": 0}

        def tick():
            state["i"] += 1
            clock.advance(0.01)
            if state["i"] % args.compact_every == 0:
                rep = autocomp.run_cycle(catalog)
                if rep.files_removed:
                    print(f"[autocomp] cycle: removed {rep.files_removed} "
                          f"files -> table now {table.file_count()} files "
                          f"(gbhr {rep.gbhr:.4f})")

    trainer = Trainer(
        RunnerConfig(total_steps=args.steps, ckpt_every=20),
        step_fn, params, opt_state, batches,
        ckpt=ckpt, autocomp_tick=tick, fault_hook=fault_hook)
    return Launch(cfg, mesh, table, pipe, store if rank0 else None, trainer)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        init_ranks(pick_backend(args.device, int(os.environ["WORLD_SIZE"])),
                   device=args.device)          # under torchrun
    run = build(args)
    rank0 = run.pipe is not None            # across ranks only rank 0 prints
    if rank0:
        print(f"[train] arch={run.cfg.name} "
              f"params={run.cfg.param_count()/1e6:.1f}M "
              f"mesh={shd.axis_sizes(run.mesh)}")
        print(f"[data] shard files: {run.table.file_count()} "
              f"(plan {run.pipe.plan()[0].path.split('/')[-1]}...)")
    t0 = time.time()
    out = run.trainer.run_with_recovery()
    dt = time.time() - t0
    losses = [h["loss"] for h in out["history"]]
    if rank0:
        print(f"[train] {out['final_step']} steps in {dt:.1f}s "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "training did not reduce loss"
    if rank0:
        print(f"[store] objects={run.store.object_count} "
              f"rpc={run.store.metrics.rpc_total}")
    return {**out, "launch": run}


if __name__ == "__main__":
    main()
