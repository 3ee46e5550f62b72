"""BENCHMARK.json against the contract it is written to, and every name
in it against the file the harness finds for it."""
from __future__ import annotations

import json
import math
import re

import pytest

from conftest import ROOT
from hpbench.harness import manifest

MAN = manifest.manifest(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E = {m["name"]: m for m in MAN["end_to_end"]}
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_paths_and_command():
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word
    files = [w for w in cmd if "/" in w]
    assert files and all(any(f.startswith(p + "/") for p in MAN["paths"])
                         for f in files)


def test_names_units_and_keys():
    names = [c["name"] for c in MAN["configs"]] + CELLS + \
        [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)
    metric_names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in E2E
        assert 1 <= len(m["layer"]) <= 200
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_pairs_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_setup_bound():
    assert E2E["setup_s"]["bound"] <= 0.25 and "workloads" not in E2E["setup_s"]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_to_its_files(workload):
    w = manifest.cell(MAN, workload)
    entry = manifest.config_entry(MAN, w["config"])
    config = manifest.config(MAN, w["config"], ROOT)
    assert config["name"] == w["config"]
    assert entry["file"] == f"hpbench/configs/{w['config']}.json"
    assert sorted(config["reduced"]) == sorted(entry["reduced"])
    traffic = manifest.traffic(w["traffic"], ROOT)
    assert callable(manifest.driver(traffic, ROOT))
    assert callable(manifest.graph(config["graph"]["kind"], ROOT).omega)
    e2e = manifest.metrics_for(MAN, workload, False)
    layer = manifest.metrics_for(MAN, workload, True)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer
    reported = {m["moves"] for m in layer}
    assert reported <= names


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_agrees_with_its_entry(metric):
    mod = manifest.metric_module(metric["name"], ROOT)
    assert callable(mod.read)
    assert mod.UNIT == metric["unit"]
    assert mod.SOURCE == metric["source"]
    if "layer" in metric:
        assert mod.LAYER == metric["layer"]
        assert mod.MOVES == metric["moves"]


def test_layers_named_alike():
    by_layer = {}
    for m in MAN["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("workload", CELLS)
def test_limits_in_every_cells_file(workload):
    limits = json.loads((ROOT / "hpbench" / "limits" / f"{workload}.json")
                        .read_text())
    assert limits == manifest.limits(workload, ROOT)
    assert "omega_gap" in limits and all(
        0 < v < 1 and math.isfinite(v) for v in limits.values())
    if manifest.traffic(manifest.cell(MAN, workload)["traffic"],
                        ROOT)["driver"] == "path":
        assert "bic_gap" in limits
