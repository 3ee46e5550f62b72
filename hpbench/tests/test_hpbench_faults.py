"""A run with the timed path broken underneath comes out not correct,
once for each fault the cells can have (on the CPU, at small sizes; the
look for a chip is skipped).  The exchange between chips does not exist
in these one-chip cells."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from conftest import small
from hpbench.harness import cell

CELLS = ["chain-p16384.path", "cortex-p4096.queue", "cortex-p4096.backlog"]
#: the queue at a rate that fills its groups at these sizes
BUSY = {"cortex-p4096.queue": {"rate_per_s": 400.0}}


def _run(workload):
    return cell.run_cell(workload, 2**31 + 7, 1.0, False, device="cpu",
                         overrides=small(workload, BUSY.get(workload)))


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"] and res["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_a_step_that_returns_its_state_unchanged(workload, monkeypatch):
    from repro_torch.core import batch, prox

    def no_gradient(omega, w, lam2):
        return torch.zeros_like(omega)

    monkeypatch.setattr(prox, "gradient_from_w", no_gradient)
    monkeypatch.setattr(batch, "gradient_from_w", no_gradient)
    assert not _run(workload)["correct"]


def test_half_of_the_path_left_out(monkeypatch):
    from repro_torch.estimator import ConcordEstimator, PathResult
    real = ConcordEstimator.fit_path

    def half(self, x=None, lam1_grid=(), **kw):
        grid = sorted(lam1_grid, reverse=True)
        keep = -(-len(grid) // 2)
        res = real(self, x, grid[:keep], **kw)
        reps = list(res.reports)
        reps += [dataclasses.replace(reps[-1], lam1=l) for l in grid[keep:]]
        return PathResult(reports=tuple(reps), mode=res.mode)

    monkeypatch.setattr(ConcordEstimator, "fit_path", half)
    assert not _run("chain-p16384.path")["correct"]


@pytest.mark.parametrize("workload", CELLS[1:])
def test_half_of_the_batch_left_out(workload, monkeypatch):
    import repro_torch.estimator as est
    real = est.fit_batch

    def half(x=None, *, lam1=None, lam2=0.0, config=None, **kw):
        b = x.shape[0]
        keep = -(-b // 2)
        res = real(x=x[:keep], lam1=lam1[:keep], lam2=lam2[:keep],
                   config=config)
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        reps = list(res.reports) + [
            dataclasses.replace(res.reports[0], omega=eye)
            for _ in range(b - keep)]
        return dataclasses.replace(res, reports=tuple(reps))

    monkeypatch.setattr(est, "fit_batch", half)
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_an_answer_altered_where_it_is_produced(workload, monkeypatch):
    from repro_torch.estimator import backends, batch
    real = backends._report

    def altered(res, **kw):
        rep = real(res, **kw)
        om = rep.omega.clone()
        om[0, 1] += 1e-7 * float(om.abs().max())
        return dataclasses.replace(rep, omega=om)

    monkeypatch.setattr(backends, "_report", altered)
    monkeypatch.setattr(batch, "_report", altered)
    assert not _run(workload)["correct"]
