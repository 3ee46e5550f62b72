"""The cell ``cortex-p16384.section5`` on the CPU at a 16 x 16 cortex: a
sound run is correct, an altered estimate fails the check, each of its
per-layer readers returns a number or, where its source is absent,
None, and a program without ``fit_grid`` stops the run at once."""
from __future__ import annotations

import dataclasses
import math

import pytest

from hpbench.harness import cell

CELL = "cortex-p16384.section5"
SMALL = {"config": {"p": 256, "n": 48,
                    "graph": {"rows": 16, "cols": 16, "region": 4}}}
SEED = 2**31 + 34

#: the readers with a source on a traced CPU run (the census, the host
#: clock, the profiler's window); the device's kernels are absent there
ON_THE_CPU = ("bic_share.section5", "solve_mfu.section5",
              "idle_share.section5")
DEVICE_KERNELS = ("omega_product_roofline.section5",
                  "grad_product_roofline.section5")


def _run(traced=False):
    return cell.run_cell(CELL, SEED, 1.0, traced, device="cpu",
                         overrides=SMALL)


def test_a_sound_run_is_correct():
    res = _run()
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert set(res["checks"]) == {"omega_gap", "bic_gap"}
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"path_s", "setup_s"}
    assert res["metrics"]["path_s"]["value"] > 0


def test_an_altered_estimate_fails_the_check(monkeypatch):
    from repro_torch.estimator import backends
    real = backends._report

    def altered(res, **kw):
        rep = real(res, **kw)
        om = rep.omega.clone()
        om[0, 1] += 1e-7 * float(om.abs().max())
        return dataclasses.replace(rep, omega=om)

    monkeypatch.setattr(backends, "_report", altered)
    assert not _run()["correct"]


def test_an_altered_bic_fails_the_check(monkeypatch):
    from repro_torch.estimator import estimator
    real = estimator.pseudo_bic

    def altered(*a, **kw):
        return real(*a, **kw) * (1.0 + 1e-7)

    monkeypatch.setattr(estimator, "pseudo_bic", altered)
    res = _run()
    assert not res["correct"]
    assert res["checks"]["bic_gap"]["value"] > res["checks"]["bic_gap"][
        "limit"]


def test_readers_on_a_traced_cpu_run():
    res = _run(traced=True)
    assert res["correct"]
    for name in ON_THE_CPU:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    # no device kernel ran, so no roofline is reported
    assert not set(DEVICE_KERNELS) & set(res["metrics"])


def test_readers_without_the_census_report_none(monkeypatch):
    from repro_torch.kernels import ops

    def reset_launches():            # the launch counts alone, as before
        for counts in (ops.LAUNCHES, ops.WEIGHTED_LAUNCHES):
            counts.update(dict.fromkeys(counts, 0))

    monkeypatch.delattr(ops, "CENSUS")
    monkeypatch.setattr(ops, "reset_launches", reset_launches)
    res = _run(traced=True)
    assert res["correct"]
    assert "bic_share.section5" not in res["metrics"]
    assert "grad_product_roofline.section5" not in res["metrics"]
    assert "solve_mfu.section5" in res["metrics"]


def test_a_program_without_fit_grid_stops_at_once(monkeypatch):
    from repro_torch.estimator import ConcordEstimator
    monkeypatch.delattr(ConcordEstimator, "fit_grid")
    with pytest.raises(RuntimeError, match="fit_grid"):
        _run()
