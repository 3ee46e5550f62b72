"""The frozen reference against the program at small sizes on the CPU
(this test imports both; the reference imports nothing of the program)."""
from __future__ import annotations

import ast

import pytest
import torch

from conftest import ROOT
from hpbench.harness import generate
from hpbench.reference import concord

KW = dict(tol=1e-5, max_iters=500, max_ls=30)


def _data(p, n, seed, kind="chain"):
    graph = {"kind": "chain", "weight": 0.4} if kind == "chain" else \
        {"kind": "regions", "rows": int(p ** 0.5), "cols": int(p ** 0.5),
         "region": 4, "weight": -0.28}
    cfg = {"p": p, "n": n, "graph": graph}
    return generate.datasets(cfg, 1, seed, "cpu")[0]


def _config(variant, **kw):
    from repro_torch.estimator import SolverConfig
    return SolverConfig(backend="reference", variant=variant, dtype="float64",
                        use_pallas=True, sparse_matmul="auto", obs="off",
                        device="cpu", **kw)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cov_path_matches_the_program(seed):
    from repro_torch.core.penalty import PenaltySpec
    from repro_torch.estimator import ConcordEstimator
    x = _data(96, 64, seed)
    s = concord.sample_covariance(x)
    grid = [0.28, 0.22, 0.16]
    est = ConcordEstimator(penalty=PenaltySpec.l1(grid[0], 0.05),
                           config=_config("cov"))
    path = est.fit_path(s=s, lam1_grid=grid, n_samples=64,
                        mode="sequential")
    prob, prev = concord.CovProblem(concord.sample_covariance(x), 0.05), None
    for rep, lam1 in zip(path, grid):
        ref = concord.solve(prob, lam1, prev, **KW)
        prev = ref.omega
        assert (rep.iters, rep.ls_total) == (ref.iters, ref.ls_total)
        assert rep.converged == ref.converged
        gap = (rep.omega - ref.omega).abs().max() / ref.omega.abs().max()
        assert gap < 1e-12
        bic = concord.pseudo_bic(ref.omega, prob.s, 64)
        assert abs(rep.bic - bic) <= 1e-12 * abs(bic)


@pytest.mark.parametrize("seed", [1, 2])
def test_obs_batch_matches_the_program(seed):
    from repro_torch.estimator import fit_batch
    x = torch.stack([_data(64, 48, seed + k, "regions") for k in range(3)])
    lam1, lam2 = [0.13, 0.2, 0.24], [0.05, 0.1, 0.05]
    res = fit_batch(x=x, lam1=lam1, lam2=lam2, config=_config("obs"))
    for k, rep in enumerate(res):
        ref = concord.solve(concord.ObsProblem(x[k], lam2[k]), lam1[k],
                            **KW)
        assert (rep.iters, rep.ls_total) == (ref.iters, ref.ls_total)
        gap = (rep.omega - ref.omega).abs().max() / ref.omega.abs().max()
        assert gap < 1e-12


def test_products_sparse_and_dense_agree():
    torch.manual_seed(0)
    a = torch.randn(40, 40, dtype=torch.float64)
    b = torch.randn(40, 7, dtype=torch.float64)
    sparse = a * (a.abs() > 1.8)
    assert torch.allclose(concord.times(sparse, b), sparse @ b, atol=1e-13)
    assert torch.allclose(concord.times(a, b), a @ b, atol=1e-13)


def test_a_stalled_line_search_keeps_the_iterate():
    s = torch.eye(4, dtype=torch.float64)
    res = concord.solve(concord.CovProblem(s, 0.0), 0.1, max_iters=5,
                        max_ls=1, tol=1e-12)
    assert res.iters >= 1 and torch.isfinite(res.omega).all()


def test_reference_imports_nothing_of_the_program():
    banned = ("repro_torch", "repro", "jax", "jaxlib", "flax", "hpbench")
    for path in (ROOT / "hpbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)
