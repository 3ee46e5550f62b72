"""Solves on every scenario family of ``data/scenarios.py`` against the
JAX reference, on the CPU in float64.

The five families (``banded``, ``block``, ``erdos_renyi``, ``hub``,
``scale_free``) at p = 48, n = 200 rows drawn from the reference's seeded
stream, each solved by both packages with the Cov and Obs variants under
three penalties (l1 0.3, scad:3.7 0.3, l1 0.1), through the block-sparse
dispatch (``sparse_matmul="on"``, block 8) and the fused prox
(``use_pallas=True``; the reference's Pallas kernel in interpret mode,
the port's plain version).  Block densities range from sparse to dense
across the cases, so both branches of the dispatch run.  Held: equal
iterations, trials, ``converged`` and ``stalled``; Omega within 1e-10.
"""
import numpy as np
import pytest

from repro import data as jdata
from repro import estimator as jest
from repro.core import penalty as jpen
from repro_torch import estimator as test_
from repro_torch.core import penalty as tpen

from _torch_parity import x64  # noqa: F401

AGREE = 1e-10
FAMILIES = ["banded", "block", "erdos_renyi", "hub", "scale_free"]
PENALTIES = {"l1-0.3": ("l1", 0.3), "scad-0.3": ("scad", 0.3),
             "l1-0.1": ("l1", 0.1)}


def _spec(mod, kind, lam1):
    if kind == "scad":
        return mod.PenaltySpec.scad(lam1, 3.7, 0.05)
    return mod.PenaltySpec.l1(lam1, 0.05)


@pytest.mark.parametrize("penalty", list(PENALTIES))
@pytest.mark.parametrize("variant", ["cov", "obs"])
@pytest.mark.parametrize("family", FAMILIES)
def test_scenario_solve_matches_reference(x64, family, variant, penalty):
    x = np.asarray(jdata.make_scenario(family, p=48, seed=0).sample(
        200, seed=1), np.float64)
    kind, lam1 = PENALTIES[penalty]
    kw = dict(backend="reference", variant=variant, sparse_matmul="on",
              sparse_block=8, use_pallas=True, tol=1e-6, max_iters=300)
    want = jest.ConcordEstimator(penalty=_spec(jpen, kind, lam1),
                                 config=jest.SolverConfig(**kw)).fit(x)
    got = test_.ConcordEstimator(penalty=_spec(tpen, kind, lam1),
                                 config=test_.SolverConfig(device="cpu",
                                                           **kw)).fit(x)
    a, b = want.report_, got.report_
    assert (b.iters, b.ls_total, b.converged, b.stalled) == \
        (a.iters, a.ls_total, a.converged, a.stalled)
    np.testing.assert_allclose(b.omega.numpy(), np.asarray(a.omega),
                               rtol=0, atol=AGREE)
    assert b.block_density == pytest.approx(a.block_density, abs=1e-12)
