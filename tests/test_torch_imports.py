"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` stand
alone.

Every module under ``src/repro_torch`` imports in a fresh interpreter with
no Triton and no CUDA, and leaves neither ``jax`` nor any module of the
JAX package in ``sys.modules``; a static scan finds no import of either;
and the merge's default device refuses to run silently on the CPU.
"""

import functools
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b|from\s+repro\b"
    r"|import\s+repro\.|from\s+repro\.)", re.M)


def _port_modules():
    names = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        names.append(".".join(parts))
    return names


def test_every_port_module_imports_without_jax_or_reference():
    code = (
        "import importlib, sys\n"
        "sys.modules['triton'] = None\n"        # no Triton: import must fail
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules\n"
        "                 if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_no_jax_or_reference_import_in_source(path):
    text = (ROOT / path).read_text()
    hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(text)]
    assert not hits, f"{path}: {hits}"


def test_merge_default_device_refuses_without_cuda(monkeypatch):
    from repro_torch.data import merge_shards_fn
    from repro_torch.lst import Catalog, InMemoryStore
    from repro_torch.lst.compaction import plan_table
    from repro_torch.data import TokenShardWriter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cat = Catalog(InMemoryStore())
    t = cat.create_table("train", "corpus")
    TokenShardWriter(t, vocab=97, seed=1).trickle_append(3, 2000)
    task = plan_table(t, 1 << 20)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        merge_shards_fn(t, task, "train/corpus/data/out.toks")
    # the CPU is reachable only by asking for it
    out = functools.partial(merge_shards_fn, device="cpu")(
        t, task, "train/corpus/data/out.toks")
    assert out.num_rows == 3 * 2000
