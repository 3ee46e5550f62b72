"""The reference's two system tests (``tests/test_system.py``) on the
port, held against the reference on the same numpy draws in float64 on
the CPU: the estimation pipeline (cost model -> solver -> PPV) and the
Section 5 clustering pipeline on an 8 x 8 synthetic cortex (the same
support, the same watershed labels at every eps, the same Jaccards)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jcl
from repro.core import costmodel as jcost
from repro.core import distributed as jdist
from repro.core import graphs as jgraphs
from repro.core.prox import fit_reference
from repro_torch import estimator as test_
from repro_torch.core import clustering as tcl
from repro_torch.core import costmodel as tcost
from repro_torch.core import graphs as tgraphs

from _torch_parity import x64  # noqa: F401

AGREE = 1e-10


def test_end_to_end_estimation_pipeline(x64):
    """data -> cost model -> solver -> support metrics, single device."""
    prob = tgraphs.make_problem("chain", p=60, n=240, seed=11)
    jprob = jgraphs.make_problem("chain", p=60, n=240, seed=11)
    np.testing.assert_array_equal(prob.x, jprob.x)
    shape = tcost.ProblemShape(p=60, n=240, d=3.0)
    best = tcost.tune(shape, 1, tcost.H100)
    assert best.variant in ("cov", "obs")
    jbest = jcost.tune(jcost.ProblemShape(p=60, n=240, d=3.0), 1,
                       jcost.Machine(**dataclasses.asdict(tcost.H100)))
    assert (best.variant, best.c_x, best.c_omega) == \
        (jbest.variant, jbest.c_x, jbest.c_omega)
    x = np.asarray(prob.x, np.float64)
    want = jdist.fit(x=jnp.asarray(x), lam1=0.22, lam2=0.02, tol=1e-6,
                     max_iters=300)
    rep = test_.fit(x, lam1=0.22, lam2=0.02, tol=1e-6, max_iters=300,
                    variant=want.variant, device="cpu")
    assert rep.converged and bool(want.converged)
    assert (rep.iters, rep.ls_total) == (int(want.iters), int(want.ls_total))
    np.testing.assert_allclose(rep.omega.numpy(), np.asarray(want.omega),
                               atol=AGREE, rtol=0)
    ppv, fdr = tgraphs.ppv_fdr(rep.omega.numpy(), prob.omega0)
    assert (ppv, fdr) == jgraphs.ppv_fdr(np.asarray(want.omega),
                                         prob.omega0)
    assert ppv > 0.8, ppv


def _region_problem(side, region, n, seed):
    """``tests/test_system.py``'s 8 x 8 cortex (two drawn alike)."""
    p = side * side
    omega = np.eye(p, dtype=np.float32)
    nbrs = tcl.grid_neighbors(side, side)
    labels = np.zeros(p, dtype=np.int64)
    for idx in range(p):
        r, c = divmod(idx, side)
        labels[idx] = (r // region) * (side // region) + (c // region)
    for i in range(p):
        for j in nbrs[i]:
            if j > i and labels[i] == labels[j]:
                omega[i, j] = omega[j, i] = -0.28
    d = np.abs(omega).sum(1) - 1.0
    omega[np.diag_indices(p)] = d + 1.0
    x = tgraphs.sample_gaussian(omega, n, seed=seed)
    np.testing.assert_array_equal(x, jgraphs.sample_gaussian(omega, n,
                                                             seed=seed))
    return labels, nbrs, x


def test_clustering_pipeline_beats_marginal_baseline(x64):
    """Partial-correlation clusters >= marginal-correlation clusters on
    a region-structured problem (the Section 5 claim, miniaturized), the
    port's estimate, support, labels and scores equal to the reference's."""
    side, region, n = 8, 4, 500
    labels, nbrs, x = _region_problem(side, region, n, seed=3)
    x = x.astype(np.float64)
    s = (x.T @ x) / n

    want = fit_reference(jnp.asarray(s), 0.18, 0.05, tol=1e-5,
                         max_iters=250)
    rep = test_.ConcordEstimator(
        lam1=0.18, lam2=0.05, config=test_.SolverConfig(
            backend="reference", variant="cov", tol=1e-5, max_iters=250,
            device="cpu")).fit_cov(torch.as_tensor(s), n_samples=n).report_
    assert (rep.iters, rep.ls_total) == (int(want.iters), int(want.ls_total))
    np.testing.assert_allclose(rep.omega.numpy(), np.asarray(want.omega),
                               atol=AGREE, rtol=0)

    jsup = jgraphs.support(np.asarray(want.omega), tol=1e-4)
    jsup = jsup | jsup.T
    sup = tcl.estimate_support(rep.omega, 1e-4)
    np.testing.assert_array_equal(sup.numpy(), jsup)
    deg = tcl.degrees_from_support(sup).numpy()
    np.testing.assert_array_equal(deg, jcl.degrees_from_support(jsup))
    best = 0.0, 1
    for eps in (0.0, 0.5, 1.0):
        ph = tcl.persistence_watershed(deg.astype(float), nbrs, eps=eps)
        np.testing.assert_array_equal(
            ph, jcl.persistence_watershed(deg.astype(float), nbrs, eps=eps))
        score = tcl.modified_jaccard(ph, labels)
        assert score == pytest.approx(jcl.modified_jaccard(ph, labels),
                                      abs=1e-12)
        if score > best[0]:
            best = score, len(np.unique(ph))
    assert 0.0 < best[0] <= 1.0
    assert best[1] >= 2
