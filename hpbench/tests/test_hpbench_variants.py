"""A mix runs any configuration's variant: the driver hands the program
S (Cov) or X (Obs) as the configuration says, and the check holds the
answers against the reference of the same variant (on the CPU, at small
sizes; the look for a chip is skipped)."""
from __future__ import annotations

import dataclasses

import pytest

from conftest import SMALL
from hpbench.harness import cell, check

#: (cell, the configuration it runs here, the problem the reference
#: must solve, the keyword the program must be handed its data under)
CASES = [
    ("chain-p16384.path", "cortex-p4096", "ObsProblem", "x"),
    ("cortex-p4096.queue", "chain-p16384", "CovProblem", "s"),
    ("cortex-p4096.backlog", "chain-p16384", "CovProblem", "s"),
]
BUSY = {"cortex-p4096.queue": {"rate_per_s": 400.0}}


def _run(workload, config):
    ov = {"cell": {"config": config}, "config": SMALL[config]}
    if workload in BUSY:
        ov["traffic"] = BUSY[workload]
    return cell.run_cell(workload, 2**31 + 11, 1.0, False, device="cpu",
                         overrides=ov)


def _spy(monkeypatch):
    import repro_torch.estimator as est
    from repro_torch.estimator import ConcordEstimator
    seen = {"problems": set(), "inputs": set()}
    real_problem, real_path, real_batch = (check.problem,
                                           ConcordEstimator.fit_path,
                                           est.fit_batch)

    def problem(config, x, lam2):
        prob = real_problem(config, x, lam2)
        seen["problems"].add(type(prob).__name__)
        return prob

    def fit_path(self, *a, **kw):
        seen["inputs"].update(k for k in ("x", "s") if kw.get(k) is not None)
        return real_path(self, *a, **kw)

    def fit_batch(*a, **kw):
        seen["inputs"].update(k for k in ("x", "s") if kw.get(k) is not None)
        return real_batch(*a, **kw)

    monkeypatch.setattr(check, "problem", problem)
    monkeypatch.setattr(ConcordEstimator, "fit_path", fit_path)
    monkeypatch.setattr(est, "fit_batch", fit_batch)
    return seen


@pytest.mark.parametrize("workload,config,problem,key", CASES)
def test_the_configurations_variant_on_both_sides(workload, config, problem,
                                                  key, monkeypatch):
    seen = _spy(monkeypatch)
    res = _run(workload, config)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert seen["problems"] == {problem}
    assert seen["inputs"] == {key}


@pytest.mark.parametrize("workload,config,problem,key", CASES)
def test_an_altered_answer_fails_under_either_variant(workload, config,
                                                      problem, key,
                                                      monkeypatch):
    from repro_torch.estimator import backends, batch
    real = backends._report

    def altered(res, **kw):
        rep = real(res, **kw)
        om = rep.omega.clone()
        om[0, 1] += 1e-7 * float(om.abs().max())
        return dataclasses.replace(rep, omega=om)

    monkeypatch.setattr(backends, "_report", altered)
    monkeypatch.setattr(batch, "_report", altered)
    assert not _run(workload, config)["correct"]


def test_an_unknown_variant_is_refused():
    ov = {"config": {**SMALL["chain-p16384"], "variant": "dual",
                     "solver": {"variant": "dual"}}}
    with pytest.raises(ValueError):
        cell.run_cell("chain-p16384.path", 1, 1.0, False, device="cpu",
                      overrides=ov)
