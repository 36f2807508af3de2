"""Build and load the port's CUDA kernels.

Each source under ``kernels/csrc/`` is compiled by ``nvcc`` into a shared
library with a plain C interface, ``build/kernels/lib<name>.so`` at the
repo root, and loaded with ``ctypes``. The build happens at first use and
again whenever the source or the flags change (a SHA-256 stamp beside the
library). Nothing here runs at import time: a CPU-only machine imports the
package and never reaches ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/build.py -> repo root / build / kernels
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _stamp(source: pathlib.Path) -> str:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    source = _CSRC / f"{name}.cu"
    lib = _BUILD_DIR / f"lib{name}.so"
    stamp_path = _BUILD_DIR / f"lib{name}.so.sha256"
    stamp = _stamp(source)
    if lib.exists() and stamp_path.exists() \
            and stamp_path.read_text().strip() == stamp:
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source.name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    stamp_path.write_text(stamp + "\n")
    return lib


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every ``csrc/*.cu`` at once, one ``nvcc`` per source."""
    names = sorted(p.stem for p in _CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load ``lib<name>.so`` once per process."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build(name)))
        return _libs[name]
