"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; each lives in a data
file of its own (``hpbench/configs/<config>.json``,
``hpbench/traffic/<traffic>.json``), and the limits of the numbers its
check compares in ``hpbench/limits/<cell>.json``.  The code they name
is found by name too: the mix's ``driver`` in
``hpbench/drivers/<driver>.py``, the configuration's ground-truth graph
in ``hpbench/graphs/<kind>.py``, and each per-layer metric's reader in
``hpbench/metrics/<metric>.py``.  Adding a cell, a configuration, a
mix, a driver, a graph or a metric adds files and entries; nothing here
changes.
"""
from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "hpbench"


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(man: dict, workload: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == workload:
            return w
    names = ", ".join(w["name"] for w in man["workloads"])
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({names})")


def config_entry(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def config(man: dict, name: str, root: Path = ROOT) -> dict:
    return load_json(root / config_entry(man, name)["file"])


def traffic(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "hpbench" / "traffic" / f"{name}.json")


def limits(workload: str, root: Path = ROOT) -> dict:
    """The limit of each number the check of ``workload`` compares."""
    return load_json(root / "hpbench" / "limits" / f"{workload}.json")


def metrics_for(man: dict, workload: str, trace: bool) -> list[dict]:
    """The metric entries a run of ``workload`` reports: its end-to-end
    metrics without a trace, its per-layer metrics with one."""
    out = []
    for m in man["per_layer" if trace else "end_to_end"]:
        cells = m.get("workloads")
        if cells is None or workload in cells:
            out.append(m)
    return out


@functools.lru_cache(maxsize=None)
def module(kind: str, name: str, root: Path = ROOT):
    """The module ``hpbench/<kind>/<name>.py``, loaded from its file."""
    path = root / "hpbench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r} at {path}")
    mod_name = f"hpbench_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str, root: Path = ROOT):
    """The reader of metric ``name`` (its own file)."""
    return module("metrics", name, root)


def driver(traffic: dict, root: Path = ROOT):
    """The class that drives a mix: ``Driver`` of the mix's ``driver``."""
    return module("drivers", traffic["driver"], root).Driver


def graph(kind: str, root: Path = ROOT):
    """The ground-truth graph ``kind``'s module (its ``omega``)."""
    return module("graphs", kind, root)
