"""Synthetic ground-truth graphs, Gaussian/non-Gaussian sampling, recovery metrics.

A copy of ``repro.core.graphs`` (numpy only), plus
:func:`sample_gaussian_torch`, which draws the samples on the card: at
p = 16384 the numpy Cholesky solve takes minutes on the host.

Mirrors Section 4 of the paper: banded (chain, avg degree 2) and random
(Erdos-Renyi, avg degree ~60 at paper scale) strictly diagonally dominant
Omega^0, Gaussian samples X with cov = (Omega^0)^{-1}, and PPV/FDR support
metrics (Table 1).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Problem(NamedTuple):
    omega0: np.ndarray     # ground-truth inverse covariance (p, p)
    x: np.ndarray          # samples (n, p)
    s: np.ndarray          # sample covariance X^T X / n (p, p)


def chain_omega(p: int, *, weight: float = 0.4, dtype=np.float32) -> np.ndarray:
    """Tridiagonal (chain graph) strictly diagonally dominant Omega^0."""
    omega = np.eye(p, dtype=dtype)
    idx = np.arange(p - 1)
    omega[idx, idx + 1] = weight
    omega[idx + 1, idx] = weight
    return omega


def random_omega(
    p: int, *, avg_degree: int = 6, weight_scale: float = 0.3,
    seed: int = 0, dtype=np.float32,
) -> np.ndarray:
    """Erdos-Renyi graph with expected degree `avg_degree`, diagonally dominant."""
    rng = np.random.default_rng(seed)
    prob = min(1.0, avg_degree / max(p - 1, 1))
    upper = np.triu(rng.random((p, p)) < prob, k=1)
    signs = rng.choice([-1.0, 1.0], size=(p, p))
    mags = rng.uniform(0.5, 1.0, size=(p, p)) * weight_scale
    w = np.where(upper, signs * mags, 0.0)
    w = w + w.T
    # strict diagonal dominance => positive definite
    diag = np.abs(w).sum(axis=1) + 1.0
    omega = w + np.diag(diag)
    return omega.astype(dtype)


def sample_gaussian(omega0: np.ndarray, n: int, *, seed: int = 0) -> np.ndarray:
    """X ~ N(0, Sigma) with Sigma = inv(Omega^0), via cholesky solve.

    If Omega0 = L L^T then X = Z @ inv(L)^T has cov inv(Omega0).
    """
    rng = np.random.default_rng(seed)
    p = omega0.shape[0]
    chol = np.linalg.cholesky(omega0.astype(np.float64))
    z = rng.standard_normal((n, p))
    # solve L^T y^T = z^T  =>  y = z @ inv(L)^T
    x = np.linalg.solve(chol.T, z.T).T
    return x.astype(omega0.dtype)


def sample_gaussian_torch(omega0, n: int, generator: torch.Generator,
                          device, dtype=torch.float64) -> torch.Tensor:
    """X ~ N(0, inv(Omega^0)) drawn with torch on ``device``.

    The same construction as :func:`sample_gaussian` (Omega0 = L L^T,
    X = Z inv(L)^T) with Z from ``generator``, which must live on
    ``device``.  Torch and numpy draw different numbers from one seed, so
    the two samplers agree in distribution, not in values."""
    om = torch.as_tensor(omega0, dtype=dtype, device=device)
    chol = torch.linalg.cholesky(om)
    z = torch.randn((om.shape[0], n), generator=generator, dtype=dtype,
                    device=device)
    # L^T x^T = z^T  =>  x = z^T inv(L^T)^T
    return torch.linalg.solve_triangular(chol.T, z, upper=True).T


def sample_nongaussian(omega0: np.ndarray, n: int, *, seed: int = 0,
                       df: float = 5.0) -> np.ndarray:
    """Multivariate-t style heavy-tailed samples with the same precision
    structure — exercises CONCORD's pseudolikelihood robustness claim."""
    rng = np.random.default_rng(seed)
    g = sample_gaussian(omega0, n, seed=seed)
    chi = rng.chisquare(df, size=(n, 1)) / df
    return (g / np.sqrt(chi)).astype(omega0.dtype)


def make_problem(kind: str, p: int, n: int, *, seed: int = 0,
                 avg_degree: int = 6, gaussian: bool = True) -> Problem:
    if kind == "chain":
        omega0 = chain_omega(p)
    elif kind == "random":
        omega0 = random_omega(p, avg_degree=avg_degree, seed=seed)
    else:
        raise ValueError(f"unknown graph kind {kind!r}")
    sampler = sample_gaussian if gaussian else sample_nongaussian
    x = sampler(omega0, n, seed=seed + 1)
    s = (x.T @ x / n).astype(omega0.dtype)
    return Problem(omega0=omega0, x=x, s=s)


# ---------------------------------------------------------------------------
# Support-recovery metrics (paper Table 1)
# ---------------------------------------------------------------------------

def support(omega: np.ndarray, *, tol: float = 0.0) -> np.ndarray:
    """Boolean off-diagonal support (upper triangle)."""
    a = np.abs(np.asarray(omega))
    mask = np.triu(np.ones_like(a, dtype=bool), k=1)
    return (a > tol) & mask


def ppv_fdr(est: np.ndarray, truth: np.ndarray, *, tol: float = 1e-8):
    """Positive predictive value and false discovery rate of edge recovery."""
    e, t = support(est, tol=tol), support(truth)
    tp = np.sum(e & t)
    fp = np.sum(e & ~t)
    denom = max(tp + fp, 1)
    ppv = tp / denom
    return float(ppv), float(1.0 - ppv)


def edge_count(omega: np.ndarray, *, tol: float = 1e-8) -> int:
    return int(np.sum(support(omega, tol=tol)))


def avg_degree(omega: np.ndarray, *, tol: float = 1e-8) -> float:
    p = omega.shape[0]
    return 2.0 * edge_count(omega, tol=tol) / p
