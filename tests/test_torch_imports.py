"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` stand
alone.

Every module under ``src/repro_torch`` (the model slice's ``configs``,
``dist`` and ``models``, the training slice's ``train`` and ``launch``,
and the serving slice's ``configs.shapes``, ``models.registry``,
``dist.fanin`` and ``launch.serve`` included, the multi-rank slice's
``dist.spawn``, the serving-across-ranks slice's
``kernels.expert_a2a``, and the dry-run slice's ``launch.analysis`` and
``launch.dryrun``) imports in a fresh interpreter with no Triton and no
CUDA, and leaves neither ``jax``, nor ``ml_dtypes``, nor any module of the
JAX package in ``sys.modules``; a static scan finds no import of any of
them; and the merge's default device refuses to run silently on the CPU.
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
    r"|import\s+repro\.|from\s+repro\.|import\s+ml_dtypes\b"
    r"|from\s+ml_dtypes\b)", re.M)


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
        "             or m == 'ml_dtypes' or m.startswith('ml_dtypes.')\n"
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


def test_the_model_slice_is_collected():
    names = _port_modules()
    for mod in ("repro_torch.configs", "repro_torch.configs.paper_lm_100m",
                "repro_torch.dist.sharding", "repro_torch.dist.collectives",
                "repro_torch.models.common", "repro_torch.models.attention",
                "repro_torch.models.moe", "repro_torch.models.ssm",
                "repro_torch.models.xlstm", "repro_torch.models.transformer",
                "repro_torch.models.interop"):
        assert mod in names, mod


def test_the_serving_slice_is_collected():
    names = _port_modules()
    for mod in ("repro_torch.configs.shapes", "repro_torch.models.registry",
                "repro_torch.dist.fanin", "repro_torch.launch.serve"):
        assert mod in names, mod


def test_the_serving_slice_imports_without_jax_triton_or_cuda():
    code = (
        "import importlib, sys\n"
        "sys.modules['triton'] = None\n"
        "for name in ('repro_torch.configs.shapes', 'repro_torch.models."
        "registry', 'repro_torch.dist.fanin', 'repro_torch.launch.serve'):\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and m.split('.')[0] in ('jax', 'ml_dtypes', 'repro',\n"
        "                                     'triton'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_the_training_slice_is_collected():
    names = _port_modules()
    for mod in ("repro_torch.train", "repro_torch.train.optimizer",
                "repro_torch.train.step", "repro_torch.train.checkpoints",
                "repro_torch.train.runner", "repro_torch.launch",
                "repro_torch.launch.mesh", "repro_torch.launch.train"):
        assert mod in names, mod


def test_the_ranks_slice_is_collected():
    names = _port_modules()
    for mod in ("repro_torch.dist.spawn", "repro_torch.dist.sharding",
                "repro_torch.dist.collectives", "repro_torch.launch.mesh"):
        assert mod in names, mod


def test_the_ranks_slice_imports_without_a_process_group():
    """Importing the multi-rank modules starts no process, joins no group
    and touches no device: DTensor and the spawn context load lazily."""
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import torch.distributed as dist\n"
        "from repro_torch.dist import collectives, sharding, spawn\n"
        "from repro_torch.launch import mesh, train\n"
        "from repro_torch.train import checkpoints, step\n"
        "assert not dist.is_initialized()\n"
        "assert not collectives._staging\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'ml_dtypes', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_the_serving_ranks_slice_is_collected():
    names = _port_modules()
    for mod in ("repro_torch.kernels.expert_a2a",
                "repro_torch.kernels.expert_a2a.ops",
                "repro_torch.launch.serve", "repro_torch.dist.collectives"):
        assert mod in names, mod


def test_the_serving_ranks_slice_imports_without_a_process_group():
    """The serve launcher's meshes, reports and mover, and the expert
    all-to-all op, import without starting a process, joining a group or
    touching a device: the sub-meshes are built when called."""
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import torch.distributed as dist\n"
        "from repro_torch.kernels.expert_a2a import expert_a2a, ops\n"
        "from repro_torch.launch import serve\n"
        "from repro_torch.kernels import api\n"
        "assert 'expert_a2a' in api.ops()\n"
        "assert not dist.is_initialized()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'ml_dtypes', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_the_dry_run_slice_is_collected():
    names = _port_modules()
    for mod in ("repro_torch.launch.analysis", "repro_torch.launch.dryrun",
                "repro_torch.train.optimizer"):
        assert mod in names, mod


def test_the_dry_run_slice_imports_without_a_process_group():
    """The dry run and its analysis import without joining a group, fake
    or real, and without loading the fake backend's test module: the
    world is made when a cell needs it."""
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import torch.distributed as dist\n"
        "from repro_torch.launch import analysis, dryrun\n"
        "from repro_torch.train.optimizer import abstract_state\n"
        "assert not dist.is_initialized()\n"
        "assert 'torch.testing._internal.distributed.fake_pg' not in "
        "sys.modules\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'ml_dtypes', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
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
