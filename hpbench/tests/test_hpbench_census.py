"""The per-layer metrics read from the program's own census
(``repro_torch.census``): finite on a traced CPU run of each cell at
small sizes, and absent, without an error, from a program that keeps no
census."""
from __future__ import annotations

import math

import pytest

from conftest import small
from hpbench.harness import cell

#: each cell's metrics read from the census
READ = {
    "chain-p16384.path": ["bic_share.path", "host_syncs_per_trial.path"],
    "cortex-p4096.queue": ["host_ms_per_flat_step.queue"],
    "cortex-p4096.backlog": ["host_ms_per_flat_step.backlog"],
}
#: the queue at a rate that groups its requests at these sizes
BUSY = {"cortex-p4096.queue": {"rate_per_s": 40.0}}


def _run(workload):
    return cell.run_cell(workload, 2**31 + 11, 1.0, True, device="cpu",
                         overrides=small(workload, BUSY.get(workload)))


@pytest.mark.parametrize("workload", sorted(READ))
def test_census_metrics_read_finite(workload):
    res = _run(workload)
    assert res["correct"]
    for name in READ[workload]:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    # every other per-layer metric of the cell is still reported
    assert len(res["metrics"]) >= len(READ[workload]) + 3


@pytest.mark.parametrize("workload", sorted(READ))
def test_a_program_without_the_census_reports_none(workload, monkeypatch):
    from repro_torch.kernels import ops

    def reset_launches():            # the launch counts alone, as before
        for counts in (ops.LAUNCHES, ops.WEIGHTED_LAUNCHES):
            counts.update(dict.fromkeys(counts, 0))

    monkeypatch.delattr(ops, "CENSUS")
    monkeypatch.setattr(ops, "reset_launches", reset_launches)
    res = _run(workload)
    assert res["correct"]
    assert not set(READ[workload]) & set(res["metrics"])
