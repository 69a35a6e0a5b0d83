"""``BENCHMARK.json`` and the files its names point at.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by name:

- ``livebench/configs/<config>.json``: the configuration as it is run;
- ``livebench/traffic/<mix>.json``: the mix's generator parameters,
  ramp, conversation count and gateway settings;
- ``livebench/limits/<cell>.json``: the limit of each number that
  decides ``correct``, with the readings it was set from;
- ``livebench/metrics/<metric>.py``: a per-layer metric's reader.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(b: dict, name: str) -> dict:
    for w in b["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                   f"{[w['name'] for w in b['workloads']]}")


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def limits(cell_name: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell_name}.json").read_text())


def metric(name: str):
    """The reader module of a per-layer metric: ``UNIT``, ``MOVES`` and
    ``read(rec)``, which returns None when the run holds nothing to
    read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "livebench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end_of(b: dict, cell_name: str) -> list:
    return [m for m in b["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer_of(b: dict, cell_name: str) -> list:
    return [m for m in b["per_layer"]
            if cell_name in m.get("workloads", [cell_name])]
