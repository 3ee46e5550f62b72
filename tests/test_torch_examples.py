"""The port's examples (``examples/torch_*.py``) on the CPU:
``torch_quickstart`` against the reference estimator, the Section 5
pipeline of ``torch_brain_clustering`` against the reference's pipeline
on the same numpy draw (side 8, one lam2, two lam1: the same path
supports, labels and Jaccards), its ``main`` at the example's size, and
``torch_replication_study`` on 4 spawned gloo ranks (wall times printed,
not compared)."""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import estimator as jest
from repro.core import clustering as jcl
from repro.core import costmodel as jcost
from repro.core import graphs as jgraphs
from repro_torch import estimator as test_
from repro_torch.core import costmodel as tcost
from repro_torch.core import graphs as tgraphs

from _torch_parity import x64  # noqa: F401
from test_torch_ranks import RankPool, replication_sweep

AGREE = 1e-10
JACCARD_TOL = 1e-12
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    """``examples/<name>.py`` as a module (registered, as its dataclasses
    need)."""
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def brain():
    return _load("torch_brain_clustering")


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def test_quickstart_main_on_the_cpu(x64, capsys):
    out = _load("torch_quickstart").main([], device="cpu")
    text = capsys.readouterr().out
    assert "max |distributed - reference| = 0.00e+00" in text
    for name in ("reference", "auto", "distributed", "scad"):
        assert out[name].report_.converged, name
        assert out[name].report_.device == "cpu"
    assert out["auto"].report_.backend == "reference"
    assert len(out["path"]) == 5 and out["adaptive"].adaptive
    # the reference backend's fit equals the JAX package's on its data
    prob = jgraphs.make_problem("chain", p=120, n=300, seed=0)
    want = jest.ConcordEstimator(
        lam1=0.15, lam2=0.05, config=jest.SolverConfig(
            backend="reference", variant="cov", tol=1e-6, max_iters=300),
    ).fit_cov(jnp.asarray(prob.s, jnp.float64), n_samples=300).report_
    rep = out["reference"].report_
    assert (rep.iters, rep.ls_total) == (want.iters, want.ls_total)
    np.testing.assert_allclose(rep.omega.numpy(), np.asarray(want.omega),
                               atol=AGREE, rtol=0)


# ---------------------------------------------------------------------------
# brain clustering
# ---------------------------------------------------------------------------

def _reference_pipeline(s, n, labels, nbrs, lam2_grid, lam1_grid, eps_grid,
                        keep_grid):
    """``examples/brain_clustering.py``'s steps (i)-(iii), on given grids."""
    config = jest.SolverConfig(backend="reference", variant="cov",
                               tol=1e-5, max_iters=250)
    paths, sups, scores, best = {}, {}, {}, None
    for lam2 in lam2_grid:
        path = jest.ConcordEstimator(lam2=lam2, config=config).fit_path(
            s=jnp.asarray(s), n_samples=n, lam1_grid=lam1_grid,
            score_bic=False)
        paths[lam2] = path
        for rep in path:
            sup = jgraphs.support(np.asarray(rep.omega), tol=1e-4)
            sup = sup | sup.T
            sups[(rep.lam1, lam2)] = sup
            deg = jcl.degrees_from_support(sup)
            for eps in eps_grid:
                ph = jcl.persistence_watershed(deg.astype(float), nbrs,
                                               eps=eps)
                score = jcl.modified_jaccard(ph, labels)
                scores[(rep.lam1, lam2, eps)] = score
                if best is None or score > best[0]:
                    best = (score, rep.lam1, lam2, eps, ph, sup)
    lp = jcl.label_propagation(best[5])
    baseline = {}
    for keep in keep_grid:
        sb = jcl.threshold_covariance_graph(np.asarray(s), keep)
        degb = jcl.degrees_from_support(sb)
        phb = jcl.persistence_watershed(degb.astype(float), nbrs, eps=1.0)
        baseline[keep] = jcl.modified_jaccard(phb, labels)
    return paths, sups, scores, best, lp, baseline


def test_region_problem_is_the_reference_draw(brain):
    ref = _load("brain_clustering")
    for args in ((8, 4, 300, 0), (12, 4, 600, 0), (6, 3, 50, 2)):
        got = brain.make_region_problem(*args)
        want = ref.make_region_problem(*args)
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w


def test_region_problem_on_a_generator(brain):
    """Given a generator, X is drawn in float64 on its device."""
    gen = torch.Generator().manual_seed(3)
    omega, labels, x, nbrs, side = brain.make_region_problem(
        8, 4, 200, generator=gen)
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float64
    assert tuple(x.shape) == (200, 64)
    assert omega.dtype == np.float32 and labels.max() == 3


@pytest.mark.parametrize("lam1_grid", [(0.16, 0.2), (0.12, 0.25)])
def test_brain_pipeline_equals_the_reference(x64, brain, lam1_grid):
    lam2_grid, eps_grid = (0.05,), brain.EPS_GRID
    keep_grid = brain.KEEP_GRID
    omega0, labels, x, nbrs, side = brain.make_region_problem(8, 4, 600, 0)
    s = brain.sample_covariance(x, "cpu")
    config = test_.SolverConfig(backend="reference", variant="cov",
                                tol=1e-5, max_iters=250, device="cpu")
    got = brain.run_pipeline(s, x.shape[0], labels, nbrs, config=config,
                             lam2_grid=lam2_grid, lam1_grid=lam1_grid)
    paths, sups, scores, best, lp, baseline = _reference_pipeline(
        s.numpy(), x.shape[0], labels, nbrs, lam2_grid, lam1_grid,
        eps_grid, keep_grid)
    for lam2 in lam2_grid:
        for rep, want in zip(got.paths[lam2], paths[lam2]):
            assert (rep.lam1, rep.iters, rep.ls_total) == \
                (want.lam1, want.iters, want.ls_total)
            np.testing.assert_allclose(rep.omega.numpy(),
                                       np.asarray(want.omega), atol=AGREE,
                                       rtol=0)
            np.testing.assert_array_equal(
                got.degrees[(rep.lam1, lam2)],
                jcl.degrees_from_support(sups[(rep.lam1, lam2)]))
    assert got.scores.keys() == scores.keys()
    for key, want in scores.items():
        assert abs(got.scores[key] - want) <= JACCARD_TOL, key
    assert got.best[1:4] == best[1:4]
    assert abs(got.best[0] - best[0]) <= JACCARD_TOL
    np.testing.assert_array_equal(got.best[4], best[4])
    np.testing.assert_array_equal(got.best[5].numpy(), best[5])
    np.testing.assert_array_equal(got.lp, lp)
    assert got.lp_score == pytest.approx(jcl.modified_jaccard(lp, labels),
                                         abs=JACCARD_TOL)
    assert got.baseline.keys() == baseline.keys()
    for keep, want in baseline.items():
        assert abs(got.baseline[keep] - want) <= JACCARD_TOL, keep
    assert got.path_wall_s > 0 and got.cluster_wall_s > 0


def test_brain_clustering_main_on_the_cpu(brain, capsys):
    """The example at its own size (12 x 12 cortex, the full grid); its
    assertion holds."""
    res = brain.main([], device="cpu")
    text = capsys.readouterr().out
    assert "persistent homology: best Jaccard" in text
    assert len(res.scores) == 2 * 4 * 3 and len(res.baseline) == 3
    assert res.best[0] >= res.baseline_best - 0.05
    for path in res.paths.values():
        assert all(r.converged for r in path)


def test_brain_check_result_raises(brain):
    res = brain.PipelineResult(paths={}, degrees={}, scores={},
                               best=(0.1,), lp=np.zeros(1), lp_score=0.0,
                               baseline={0.02: 0.5}, path_wall_s=0.0,
                               graph_wall_s=0.0, cluster_wall_s=0.0)
    with pytest.raises(AssertionError, match="match/beat"):
        brain.check_result(res)


# ---------------------------------------------------------------------------
# replication study
# ---------------------------------------------------------------------------

def test_replication_candidates():
    mod = _load("torch_replication_study")
    assert mod.candidates(1) == [(1, 1)]
    assert mod.candidates(4) == [(1, 1), (1, 2), (1, 4), (2, 1), (2, 2),
                                 (4, 1)]


def test_replication_study_on_four_gloo_ranks():
    """The sweep on P = 4 ranks: every pair of the grid, every rank's
    estimate equal to the single-device solve (counts exact, Omega within
    1e-10), the model column the port's ``obs_costs`` (= the reference's
    at equal machine constants)."""
    pool = RankPool(4)
    try:
        ranks = pool.run(replication_sweep)
    finally:
        pool.close()
    prob = tgraphs.make_problem("chain", p=64, n=32, seed=0)
    x = np.asarray(prob.x, np.float64)
    single = test_.ConcordEstimator(
        lam1=0.2, lam2=0.05, config=test_.SolverConfig(
            backend="reference", variant="obs", tol=1e-5, max_iters=50,
            device="cpu")).fit(x).report_
    shape = tcost.ProblemShape(p=64, n=32, d=3.0, s=30, t=6.0)
    jm = jcost.Machine(**dataclasses.asdict(tcost.H100))
    jshape = jcost.ProblemShape(p=64, n=32, d=3.0, s=30, t=6.0)
    pairs = [(1, 1), (1, 2), (1, 4), (2, 1), (2, 2), (4, 1)]
    for rows in ranks:
        assert [(r["c_x"], r["c_omega"]) for r in rows] == pairs
        for r in rows:
            print(f"rank wall c_x={r['c_x']} c_omega={r['c_omega']}: "
                  f"{r['wall_s']:.4f} s")
            assert (r["iters"], r["ls_total"], r["converged"]) == \
                (single.iters, single.ls_total, single.converged)
            np.testing.assert_allclose(r["omega"], single.omega.numpy(),
                                       atol=AGREE, rtol=0)
            assert r["model_s"] == tcost.obs_costs(
                shape, 4, r["c_x"], r["c_omega"], tcost.H100).total
            assert r["model_s"] == jcost.obs_costs(
                jshape, 4, r["c_x"], r["c_omega"], jm).total
