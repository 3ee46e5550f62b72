"""On the card: the control (the reference in float32, TF32 off, in the
program's place) fails the cell's limits, and the program
passes them, at sizes a test run holds.  The cells' own sizes are read
by ``hpbench/calibrate.py limits`` (PERF.md gives the readings).

    python -m pytest -q -p no:cacheprovider -m gpu hpbench/tests
"""
from __future__ import annotations

import pytest
import torch

from conftest import ROOT
from hpbench.harness import cell, check, manifest

pytestmark = pytest.mark.gpu

MID = {"chain-p16384.path": {"config": {"p": 2048, "n": 1024}},
       "cortex-p4096.backlog": {"config": {
           "p": 1024, "graph": {"rows": 32, "cols": 32, "region": 16}}}}


def _mix(workload, seed, device):
    man = manifest.manifest(ROOT)
    c = manifest.cell(man, workload)
    config = cell._merge(manifest.config(man, c["config"], ROOT),
                         MID[workload]["config"])
    traffic = manifest.traffic(c["traffic"], ROOT)
    return manifest.driver(traffic, ROOT)(config, traffic, seed,
                                          device), config


@pytest.mark.parametrize("workload", sorted(MID))
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails_the_limits(workload, seed, cuda_device):
    drv, config = _mix(workload, seed, cuda_device)
    drv.setup(2.0)
    items = drv.planned()
    refs = check.reference(drv, items, config)
    ctrl = check.reference(drv, items, config, dtype=torch.float32)
    ok, shown = check.verdict(check.gaps(ctrl, refs),
                              manifest.limits(workload, ROOT))
    assert not ok, shown


@pytest.mark.parametrize("workload", sorted(MID))
def test_program_meets_the_limits(workload, cuda_device):
    res = cell.run_cell(workload, 21, 2.0, False, device=cuda_device,
                        overrides=MID[workload])
    assert res["correct"], res["checks"]
