"""The benchmark's layout: every cell of ``BENCHMARK.json`` resolves to its
files by name, the file keeps to its contract, a new cell is taken as data,
and nothing under ``bench/`` imports JAX or the JAX package."""

import ast
import copy
import json
import pathlib
import re

import pytest

from portbench import registry

BENCH = pathlib.Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench"]
    assert bench["command"] == ["python3", "bench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_sources(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  registry.benchmark()["workloads"]])
def test_cell_resolves(bench, cell):
    """Config, mix, driver and every metric reader exist by name; the cell
    reports setup_s, one more end-to-end metric and a per-layer one."""
    w = registry.cell(cell, bench)
    cfg = registry.config(w["config"])
    assert cfg["name"] == w["config"]
    mix = registry.mix(w["traffic"])
    assert hasattr(registry.driver(mix["driver"]), "Driver")
    e2e = [m["name"] for m in registry.end_to_end(bench, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = registry.per_layer(bench, cell)
    assert layer
    for m in layer:
        assert m["moves"] in e2e
        assert callable(registry.metric_reader(m["name"]).read)
    assert w["chips"] == 1 and len(w["why"]) <= 200


def test_config_entries_match_files(bench):
    for c in bench["configs"]:
        path = BENCH.parent / c["file"]
        data = json.loads(path.read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert sorted(data["reduced"]) == sorted(c["reduced"])
        for k in c["reduced"]:
            assert not k.endswith(("_dim", "_rank", "_size")), k


def test_a_new_cell_is_data(monkeypatch, bench):
    """A later cell that names an existing configuration and mix needs no
    code: the registry finds all of its pieces."""
    new = copy.deepcopy(bench)
    new["workloads"].append({"name": "serve-decode-8", "config":
                             "granite-3-8b", "traffic": "slots-chat",
                             "chips": 1, "why": "x"})
    new["end_to_end"][0]["workloads"].append("serve-decode-8")
    monkeypatch.setattr(registry, "benchmark", lambda: new)
    w = registry.cell("serve-decode-8")
    assert registry.mix(w["traffic"])["driver"] == "serve_slots"
    assert [m["name"] for m in registry.end_to_end(new, "serve-decode-8")] \
        == ["serve_tok_s", "setup_s"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py")))
def test_no_jax(path):
    """Top-level names compared whole: ``repro_torch`` is the program,
    ``repro`` the JAX package."""
    names = set(_imports(BENCH / path))
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names
    if path.startswith("reference/"):
        assert "repro_torch" not in names and "portbench" not in names
