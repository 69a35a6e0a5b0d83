"""The manifest keeps to the benchmark's contract, every name finds its
file, and nothing the benchmark runs imports JAX or the JAX package."""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from livebench import manifest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["livebench"]
    assert BENCH["command"][1] == "livebench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 2 + 14 * 24 and (2 + 14 * 24) * (BENCH["run_seconds"] + 60) \
        + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_keys(kind):
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }[kind]
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert set(e) <= allowed, e
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        if kind == "end_to_end":
            assert 0.01 <= e["bound"] <= 0.25
            assert e["source"] in ("host_clock", "device_trace")
        if kind == "workloads":
            assert e["chips"] in (1, 4) and NAME.match(e["config"]) \
                and NAME.match(e["traffic"])
        if kind == "configs":
            assert all(NAME.match(k) for k in e["reduced"])


def test_every_name_finds_its_file():
    cells = {w["name"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"livebench/configs/{c['name']}.json"
        assert manifest.config(c["name"])["model"]
    for w in BENCH["workloads"]:
        assert manifest.traffic(w["traffic"])["gateway"]
        assert manifest.limits(w["name"])["compare"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        mod = manifest.metric(m["name"])
        assert mod.UNIT == m["unit"] and mod.MOVES == m["moves"]
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            # the cell reports the end-to-end metric this one moves
            assert any(x["name"] == m["moves"] and w in x.get(
                "workloads", cells) for x in BENCH["end_to_end"])


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in FORBIDDEN, (f, mod)
    for f in sorted((HERE / "reference").rglob("*.py")):
        for mod in _imports(f):
            assert mod.split(".")[0] != "repro_torch", (f, mod)


def test_the_import_check_compares_whole_names():
    from livebench.run import FORBIDDEN as RUN_FORBIDDEN
    assert "repro" in RUN_FORBIDDEN and "repro_torch" not in RUN_FORBIDDEN
    assert "repro_torch".split(".")[0] not in FORBIDDEN
