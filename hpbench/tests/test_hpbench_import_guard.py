"""No run loads JAX or the JAX package: a cell's modules, reference
included, run in a subprocess on the CPU, then ``sys.modules`` is read."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, SMALL
from hpbench.harness import guard

CODE = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
from hpbench.harness import cell, guard
res = cell.run_cell({w!r}, 2**31 + 99, 1.0, {traced}, device="cpu",
                    overrides={ov!r})
print(json.dumps({{"correct": res["correct"],
                  "forbidden": guard.forbidden_modules(),
                  "loaded": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("workload,traced", [
    ("chain-p16384.path", True), ("cortex-p4096.queue", False),
    ("cortex-p4096.backlog", True)])
def test_a_run_loads_no_jax_and_no_reference_package(workload, traced):
    ov = {"config": SMALL[workload.split(".")[0]]}
    code = CODE.format(src=str(ROOT / "src"), root=str(ROOT), w=workload,
                       traced=traced, ov=ov)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=_env(), cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert res["forbidden"] == []
    assert "repro_torch" in res["loaded"] and "hpbench" in res["loaded"]


def test_names_are_compared_whole():
    mods = {"repro_torch": 0, "repro_torch.core": 0, "jaxtyping": 0,
            "reprolib": 0, "flaxen.x": 0}
    assert guard.forbidden_modules(mods) == []
    mods.update({"repro.core.prox": 0, "jax": 0, "jaxlib.xla": 0, "flax": 0})
    assert guard.forbidden_modules(mods) == ["flax", "jax", "jaxlib.xla",
                                             "repro.core.prox"]


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "hpbench/run.py", "--workload", "chain-p16384.path",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd, env=_env())


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card path does not run here")
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "hpbench", tmp_path / "hpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
