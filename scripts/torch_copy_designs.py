#!/usr/bin/env python3
"""Times the port's compact_chunks kernel beside two persistent designs of
the same gather and ``index_select``, on one card.

    python3 scripts/torch_copy_designs.py [--rounds 2] [--reps 50]

On one 511-file bin of ``chip_smoke.py``'s main path (130,816 int32
chunks of 4 KiB), with the identity map the main path gives and with a
random permutation, it times ``compact_chunks_kernel`` (the package's),
the designs of ``scripts/torch_copy_schemes.cu`` (``warp_copy``: 2 CTAs
per SM whose warps stride over whole chunks; ``bulk_copy``: a ring of
``cp.async.bulk`` copies, 3 CTAs per SM) and ``torch.index_select``, by
``chip_smoke.time_ms``: the host's launch included, and the device's time
alone. Every output is checked bit for bit first. It prints the card and
one JSON line per round and map.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.compact_pack import compact_pack as ck  # noqa: E402

DESIGNS = {"warp_copy": 2, "bulk_copy": 3}   # CTAs per SM


def load_designs(scratch: str) -> ctypes.CDLL:
    lib = os.path.join(scratch, "libcopy_designs.so")
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", lib,
                    os.path.join(ROOT, "scripts", "torch_copy_schemes.cu")],
                   check=True)
    lib = ctypes.CDLL(lib)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for name in DESIGNS:
        getattr(lib, f"{name}_launch").argtypes = [ptr, ptr, ptr, i64, i64,
                                                   i64, ptr]
    return lib


def design(lib, name, n_sms, src, cm):
    out = torch.empty_like(src[:cm.shape[0]])
    err = getattr(lib, f"{name}_launch")(
        src.data_ptr(), out.data_ptr(), cm.data_ptr(), cm.shape[0],
        src.stride(0) * src.element_size(), DESIGNS[name] * n_sms,
        torch.cuda.current_stream().cuda_stream)
    build.raise_on(err, name)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_copy_designs: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cs.phase_device()
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    scratch = tempfile.mkdtemp(prefix="copy_designs_")
    lib = load_designs(scratch)
    n = cs.bin_chunks(argparse.Namespace(**cs.DEFAULTS))
    src = cs.random_payload(n * cs.CHUNK_TOKENS, torch.int32, dev,
                            torch.Generator().manual_seed(99)).view(
        -1, cs.CHUNK_ROWS, cs.CHUNK_COLS)
    nb = 2 * n * cs.CHUNK_TOKENS * 4 + 4 * n
    maps = {"identity": np.arange(n, dtype=np.int32),
            "permuted": np.random.RandomState(5).permutation(n).astype(
                np.int32)}
    for label, m in maps.items():
        cm = torch.from_numpy(m).to(dev)
        cm_long = cm.long()
        runs = {"compact_chunks": lambda: ck.compact_chunks_kernel(src, cm),
                **{d: (lambda d=d: design(lib, d, n_sms, src, cm))
                   for d in DESIGNS},
                "index_select": lambda: torch.index_select(src, 0, cm_long)}
        want = src[cm_long]
        for name, fn in runs.items():
            assert cs.same_bits(fn(), want), (label, name)
        del want
        for r in range(args.rounds):
            row = {"map": label, "round": r, "chunks": n, "bytes": nb,
                   "bound_ms": 1e3 * nb / cs.HBM_BYTES_PER_S}
            for name, fn in runs.items():
                row[name] = {
                    "ms": cs.time_ms(fn, args.reps),
                    "device_ms": cs.time_ms(fn, args.reps, device_only=True)}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
