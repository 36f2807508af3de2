"""A group of ranks in spawned processes, joined with a time limit.

``run_ranks(fn, world, *args)`` starts ``world`` processes with the
``spawn`` method, calls ``fn(rank, world, init_method, *args)`` in each,
and returns the ranks' results in rank order. ``init_method`` is a
``file://`` rendezvous in a fresh directory, for
``torch.distributed.init_process_group`` (or ``launch.mesh.init_ranks``).
A rank that raises sends its traceback back, and ``run_ranks`` raises it;
a group that outlives ``timeout`` seconds is killed, rank by rank, and
``run_ranks`` raises ``TimeoutError``: no group outlives its call.

``fn`` and its arguments and results cross processes by pickle: ``fn``
is a module-level function, the results plain data (numbers, numpy
arrays, dicts).
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional


def _entry(fn, rank: int, world: int, init_method: str, args: tuple,
           results) -> None:
    import torch.distributed as dist

    try:
        out = fn(rank, world, init_method, *args)
        results.put((rank, True, out))
    except BaseException:                      # sent back, raised there
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args: Any, timeout: float = 120.0,
              tmp_dir: Optional[str] = None) -> List[Any]:
    """``fn(rank, world, init_method, *args)`` on ``world`` spawned ranks;
    their results in rank order."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    root = tempfile.mkdtemp(prefix="ranks-", dir=tmp_dir)
    init_method = "file://" + os.path.join(root, "rendezvous")
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(fn, r, world, init_method, args, results))
             for r in range(world)]
    got = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks of {fn.__name__} did not "
                                   f"finish in {timeout:.0f} s; "
                                   f"{sorted(got)} did")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)}
                if dead:
                    raise RuntimeError(f"ranks of {fn.__name__} died without "
                                       f"a result (rank: exit code) {dead}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {fn.__name__} "
                                   f"raised:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(root, ignore_errors=True)
    return [got[r] for r in range(world)]
