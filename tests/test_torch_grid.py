"""Section 5's (lam1, lam2) grid on the port's normal path, on the CPU:
``ConcordEstimator.fit_grid`` on Obs against the benchmark's plain
reference (``hpbench/reference/concord.py``, plain PyTorch), the Obs
BIC from Omega X^T against the BIC on S formed from X, an Obs path and
grid that never form S, a Cov grid equal to its paths, the census's
``grad.obs`` and ``fit_grid`` counts, and the Obs path's BIC against
the JAX facade."""
import importlib.util
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import estimator as jest
from repro_torch import census
from repro_torch import estimator as test_
from repro_torch.core import matops
from repro_torch.estimator import backends
from repro_torch.estimator import report as treport
from repro_torch.kernels import ops

from _torch_parity import x64  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

#: Section 5's grid
LAM1_GRID = (0.25, 0.2, 0.16, 0.12)
LAM2_GRID = (0.05, 0.1)

#: a seeded 12 x 12 cortex, regions of 4 x 4, one subject of 60 frames
SIDE, REGION, N = 12, 4, 60

#: the reference's solve, as the benchmark's configurations set it
SOLVE = dict(tol=1e-5, max_iters=500, max_ls=30)

#: the dispatch on: 18 x 18 tiles of 8, block-sparse up to half of them
KNOBS = dict(use_pallas=True, sparse_matmul="on", sparse_block=8,
             sparse_threshold=0.5)
POLICY = matops.MatmulPolicy("on", block_size=8, threshold=0.5)


def _load(rel: str):
    """A file of the benchmark (plain PyTorch, no JAX), loaded by path and
    registered, as its dataclasses need."""
    path = REPO / rel
    name = "grid_test_" + path.stem
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def concord():
    return _load("hpbench/reference/concord.py")


@pytest.fixture(scope="module")
def cortex():
    """(X, its S) of one subject: N draws of N(0, inv(Omega0)), Omega0
    the benchmark's region graph on a SIDE x SIDE grid, float64."""
    regions = _load("hpbench/graphs/regions.py")
    p = SIDE * SIDE
    omega0 = regions.omega({"rows": SIDE, "cols": SIDE, "region": REGION,
                            "weight": -0.28}, p, "cpu")
    gen = torch.Generator().manual_seed(34)
    z = torch.randn((p, N), generator=gen, dtype=torch.float64)
    chol = torch.linalg.cholesky(omega0)
    x = torch.linalg.solve_triangular(chol.T, z, upper=True).T.contiguous()
    return x, (x.T @ x) / N


def _config(variant="obs", **kw):
    return test_.SolverConfig(backend="reference", variant=variant,
                              device="cpu", **{**SOLVE, **KNOBS, **kw})


def _grid(x, variant="obs", **kw):
    est = test_.ConcordEstimator(config=_config(variant, **kw))
    return est.fit_grid(x, lam1_grid=LAM1_GRID, lam2_grid=LAM2_GRID)


def _banded_or_dense(kind: str, p: int = SIDE * SIDE) -> torch.Tensor:
    """A banded Omega (a third of the tiles occupied) or a dense one."""
    rng = np.random.default_rng(7)
    if kind == "banded":
        off = -0.4 * rng.uniform(0.5, 1.0, p - 1)
        om = 1.5 * np.eye(p) + np.diag(off, 1) + np.diag(off, -1)
    else:
        g = 0.05 * rng.standard_normal((p, p))
        om = 2.0 * np.eye(p) + g + g.T
    return torch.as_tensor(om)


# ---------------------------------------------------------------------------
# fit_grid against the plain reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sparse_matmul", ["on", "off"])
def test_obs_grid_matches_the_plain_reference(concord, cortex,
                                              sparse_matmul):
    """Each lam2's warm path from the identity, its Omegas within 1e-9
    and its BICs (the reference's on S formed from X) within 1e-9
    relative."""
    x, s = cortex
    grid = _grid(x, sparse_matmul=sparse_matmul)
    assert tuple(grid.paths) == LAM2_GRID and len(grid) == 8
    for lam2, path in grid.paths.items():
        assert path.lam1_grid == LAM1_GRID
        prob, prev = concord.ObsProblem(x, lam2), None
        for rep in path:
            assert rep.lam2 == lam2 and rep.variant == "obs"
            ref = concord.solve(prob, rep.lam1, prev, **SOLVE)
            prev = ref.omega
            assert (rep.iters, rep.ls_total, rep.converged) == \
                (ref.iters, ref.ls_total, ref.converged)
            gap = float((rep.omega - ref.omega).abs().max()
                        / ref.omega.abs().max())
            assert gap <= 1e-9, (lam2, rep.lam1, gap)
            want = concord.pseudo_bic(ref.omega, s, N)
            assert abs(rep.bic - want) <= 1e-9 * abs(want), (lam2, rep.lam1)
    best = grid.best_bic()
    assert best.bic == min(r.bic for r in grid)
    assert (best.lam1, best.lam2) in {(a, b) for a in LAM1_GRID
                                      for b in LAM2_GRID}


# ---------------------------------------------------------------------------
# the Obs BIC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,route", [
    (None, None), (matops.DENSE, None), (POLICY, "dispatch")],
    ids=["none", "off", "on"])
@pytest.mark.parametrize("kind", ["banded", "dense"])
def test_obs_bic_equals_the_bic_on_s(cortex, policy, route, kind):
    """BIC from Y = Omega X^T equals the BIC on S = X^T X / n to 1e-12,
    with the dispatch off and on (there each Omega takes its route, one
    product and one host read)."""
    x, s = cortex
    om = _banded_or_dense(kind)
    on_s = treport.pseudo_bic(om, s, N, policy=policy)
    ops.reset_launches()
    on_x = treport.pseudo_bic(om, None, N, x=x, policy=policy)
    assert math.isfinite(on_x)
    np.testing.assert_allclose(on_x, on_s, rtol=1e-12)
    c = census.CENSUS
    assert c.syncs["estimator/report.py:pseudo_bic"] == 1
    taken = {k for k in ("matmul.sparse", "matmul.dense") if c.spans.get(k)}
    if route is None:
        assert not taken
    else:
        assert taken == {"matmul.sparse" if kind == "banded"
                         else "matmul.dense"}
        assert c.spans[taken.pop()] == 1


@pytest.mark.parametrize("policy", [None, POLICY], ids=["off", "on"])
def test_obs_bic_of_a_nonpositive_diagonal_is_inf(cortex, policy):
    x, _ = cortex
    bad = _banded_or_dense("banded")
    bad[5, 5] = -1.0
    assert treport.pseudo_bic(bad, None, N, x=x, policy=policy) == math.inf


@pytest.mark.parametrize("args,error", [
    (dict(s=None, x=None, n=N), ValueError),
    (dict(s="s", x="x", n=N), ValueError),
    (dict(s="s", x=None), TypeError)])
def test_pseudo_bic_takes_s_or_x_and_n(cortex, args, error):
    """One of s and x, and the sample count, which has no default."""
    x, s = cortex
    data = {"s": s, "x": x, None: None}
    counts = (args["n"],) if "n" in args else ()
    with pytest.raises(error):
        treport.pseudo_bic(_banded_or_dense("banded"), data[args["s"]],
                           *counts, x=data[args["x"]])


# ---------------------------------------------------------------------------
# no S on Obs
# ---------------------------------------------------------------------------

def _fit_path(est, x):
    return [est.fit_path(x, lam1_grid=LAM1_GRID[:2])]


def _fit_grid(est, x):
    return list(est.fit_grid(x, lam1_grid=LAM1_GRID[:2],
                             lam2_grid=LAM2_GRID).paths.values())


@pytest.mark.parametrize("call", [_fit_path, _fit_grid],
                         ids=["fit_path", "fit_grid"])
def test_an_obs_path_never_forms_s(cortex, monkeypatch, call):
    x, _ = cortex

    def no_cov(self):
        raise AssertionError("an Obs path formed S")

    monkeypatch.setattr(backends.Problem, "cov", no_cov)
    est = test_.ConcordEstimator(lam2=0.05, config=_config())
    for path in call(est, x):
        assert len(path) == 2
        assert all(r.bic is not None and math.isfinite(r.bic) for r in path)


# ---------------------------------------------------------------------------
# Cov: the grid is its paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("score_bic", [True, False])
def test_cov_grid_equals_its_paths_bit_for_bit(cortex, score_bic):
    _, s = cortex
    cfg = _config("cov")
    grid = test_.ConcordEstimator(config=cfg).fit_grid(
        s=s, n_samples=N, lam1_grid=LAM1_GRID, lam2_grid=LAM2_GRID,
        score_bic=score_bic)
    for lam2 in LAM2_GRID:
        path = test_.ConcordEstimator(lam2=lam2, config=cfg).fit_path(
            s=s, n_samples=N, lam1_grid=LAM1_GRID, score_bic=score_bic)
        got = grid.paths[lam2]
        assert len(got) == len(path) == 4
        for a, b in zip(got, path):
            assert torch.equal(a.omega, b.omega)
            assert (a.lam1, a.lam2, a.iters, a.ls_total, a.bic) == \
                (b.lam1, b.lam2, b.iters, b.ls_total, b.bic)
    flat = [r for path in grid.paths.values() for r in path]
    assert len(grid) == len(flat) and all(
        a is b for a, b in zip(grid, flat))
    if not score_bic:
        with pytest.raises(ValueError, match="no BIC"):
            grid.best_bic()


def test_the_last_point_lands_on_the_estimator(cortex):
    """As after ``fit_path``: ``report_`` / ``omega_`` are the last point
    solved, the last lam2's smallest lam1."""
    x, _ = cortex
    est = test_.ConcordEstimator(config=_config())
    grid = est.fit_grid(x, lam1_grid=LAM1_GRID[:2], lam2_grid=LAM2_GRID)
    last = grid.paths[LAM2_GRID[-1]][-1]
    assert est.report_ is last
    assert (last.lam1, last.lam2) == (LAM1_GRID[1], LAM2_GRID[-1])
    assert torch.equal(est.omega_, last.omega)


@pytest.mark.parametrize("lam2_grid", [(), (0.05, 0.05), (-0.1,),
                                       (math.nan,)])
def test_a_bad_lam2_grid_is_refused(cortex, lam2_grid):
    x, _ = cortex
    with pytest.raises(ValueError, match="lam2_grid"):
        test_.ConcordEstimator(config=_config()).fit_grid(
            x, lam1_grid=LAM1_GRID, lam2_grid=lam2_grid)


# ---------------------------------------------------------------------------
# the census
# ---------------------------------------------------------------------------

def test_census_counts_the_obs_gradients_and_the_grid(cortex):
    """One ``grad.obs`` an outer iteration, one ``fit_grid`` a call, one
    ``fit_path`` a lam2 and one ``bic`` a point."""
    x, _ = cortex
    ops.reset_launches()
    grid = _grid(x)
    c = census.CENSUS
    assert c.spans["grad.obs"] == sum(r.iters for r in grid) > 0
    assert c.spans["fit_grid"] == 1
    assert c.spans["fit_path"] == len(LAM2_GRID)
    assert c.spans["bic"] == c.syncs["estimator/report.py:pseudo_bic"] == 8


# ---------------------------------------------------------------------------
# against the JAX facade
# ---------------------------------------------------------------------------

def test_obs_path_bic_matches_the_jax_facade(x64, cortex):
    """The Obs path's BIC from Omega X^T equals the JAX facade's, which
    forms S, at the report scalars' 1e-9; each grid path is that path."""
    x, _ = cortex
    xn = x.numpy()
    jcfg = jest.SolverConfig(backend="reference", variant="obs", **SOLVE,
                             **KNOBS)
    grid = _grid(x)
    for lam2 in LAM2_GRID:
        jpath = jest.ConcordEstimator(lam2=lam2, config=jcfg).fit_path(
            jnp.asarray(xn), list(LAM1_GRID))
        tpath = test_.ConcordEstimator(lam2=lam2, config=_config()).fit_path(
            xn, list(LAM1_GRID))
        for jr, tr, gr in zip(jpath, tpath, grid.paths[lam2]):
            assert (tr.iters, tr.ls_total) == (jr.iters, jr.ls_total)
            np.testing.assert_allclose(tr.omega.numpy(), np.asarray(jr.omega),
                                       rtol=0, atol=1e-10)
            np.testing.assert_allclose(tr.bic, jr.bic, rtol=1e-9)
            assert torch.equal(gr.omega, tr.omega) and gr.bic == tr.bic
        assert tpath.best_bic().lam1 == jpath.best_bic().lam1
