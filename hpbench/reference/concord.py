"""Plain CONCORD proximal gradient: the benchmark's reference solve.

Written from the paper (Koanantakool et al., arXiv:1710.10769,
Algorithms 1-3) in plain PyTorch.  It imports nothing of the program and
takes nothing the program made: it is handed the benchmark's own X (or
its S), works out what it needs from them, and solves from the identity
or from its own previous estimate.

    g(O)   = -sum_i log O_ii + 1/2 tr(O S O) + lam2/2 ||O||_F^2
    h(O)   = lam1 ||offdiag(O)||_1
    grad g = -diag(1 / O_ii) + (W + W^T)/2 + lam2 O,      W = O S

Cov works on S; Obs never forms S (tr(O S O) = ||O X^T||_F^2 / n and
W = (O X^T) X / n).  Each outer iteration takes one gradient and
backtracks from tau = 1, halving, until
g(O+) <= g(O) + <O+ - O, G> + ||O+ - O||^2 / (2 tau), for at most
``max_ls`` trials (a miss stalls the solve); it stops once
||O+ - O||_F / max(1, ||O||_F) < tol.

The products with the iterate go through a CSR copy of it when it is
sparse (a quarter of its entries or fewer nonzero), else dense.  Every
operation runs in the dtype of the data it is given, so the same code
in float32 is the benchmark's control.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass

import torch

#: a product goes through the CSR copy of the iterate at or below this
#: share of nonzero entries
SPARSE_SHARE = 0.25

#: |entry| above this counts as an edge in the pseudo-likelihood BIC
EDGE_TOL = 1e-8


@dataclass(frozen=True)
class Solve:
    omega: torch.Tensor
    iters: int
    ls_total: int
    converged: bool
    stalled: bool


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def times(omega: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """omega @ b, through a CSR copy of omega where it is sparse."""
    nnz = int(torch.count_nonzero(omega))
    if nnz <= SPARSE_SHARE * omega.numel():
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="Sparse CSR tensor")
            return omega.to_sparse_csr() @ b
    return omega @ b


def soft_threshold_offdiag(z: torch.Tensor, alpha: float) -> torch.Tensor:
    out = torch.sign(z) * torch.clamp(z.abs() - alpha, min=0.0)
    out.diagonal().copy_(z.diagonal())
    return out


class CovProblem:
    """The Cov variant on a (p, p) sample covariance."""

    def __init__(self, s: torch.Tensor, lam2: float):
        self.s, self.lam2 = s, lam2

    def aux(self, omega):
        return times(omega, self.s)

    def quad(self, omega, w):
        return _dot(w, omega)

    def w_of(self, omega, w):
        return w


class ObsProblem:
    """The Obs variant on (n, p) observations; S is never formed."""

    def __init__(self, x: torch.Tensor, lam2: float):
        self.x, self.xt, self.lam2 = x, x.T.contiguous(), lam2
        self.n = x.shape[0]

    def aux(self, omega):
        return times(omega, self.xt)

    def quad(self, omega, y):
        return _dot(y, y) / self.n

    def w_of(self, omega, y):
        return (y @ self.x) / self.n


def _smooth(prob, omega, aux) -> float:
    d = omega.diagonal()
    if not bool(d.min() > 0):
        return math.inf
    g = (-torch.log(d).sum() + 0.5 * prob.quad(omega, aux)
         + 0.5 * prob.lam2 * _dot(omega, omega))
    g = float(g)
    return math.inf if math.isnan(g) else g


def _gradient(prob, omega, aux):
    w = prob.w_of(omega, aux)
    grad = 0.5 * (w + w.T) + prob.lam2 * omega
    grad.diagonal().sub_(1.0 / omega.diagonal())
    return grad


def solve(prob, lam1: float, omega0: torch.Tensor | None = None, *,
          tol: float, max_iters: int, max_ls: int) -> Solve:
    """One CONCORD solve; ``omega0`` defaults to the identity."""
    like = prob.s if isinstance(prob, CovProblem) else prob.x
    p = like.shape[-1]
    omega = (torch.eye(p, dtype=like.dtype, device=like.device)
             if omega0 is None else omega0.to(like.dtype).clone())
    aux = prob.aux(omega)
    g = _smooth(prob, omega, aux)
    iters = ls_total = 0
    delta, stalled = math.inf, False
    while iters < max_iters and delta >= tol:
        grad = _gradient(prob, omega, aux)
        norm2 = float(_dot(omega, omega))
        tau, trials = 1.0, 0
        while True:
            if trials:
                tau *= 0.5
            cand = soft_threshold_offdiag(omega - tau * grad, tau * lam1)
            aux_c = prob.aux(cand)
            g_c = _smooth(prob, cand, aux_c)
            diff = cand - omega
            dd = float(_dot(diff, diff))
            ok = g_c <= g + float(_dot(diff, grad)) + dd / (2.0 * tau)
            trials += 1
            if ok or trials >= max_ls:
                break
        ls_total += trials
        iters += 1
        if ok:
            omega, aux, g = cand, aux_c, g_c
            delta = math.sqrt(dd) / max(1.0, math.sqrt(norm2))
        else:
            stalled, delta = True, 0.0
    return Solve(omega=omega, iters=iters, ls_total=ls_total,
                 converged=delta < tol and not stalled, stalled=stalled)


def pseudo_bic(omega: torch.Tensor, s: torch.Tensor, n: int) -> float:
    """2 n g0(O) + log(n) |E|: g0 the unpenalized smooth objective without
    the ridge, |E| the off-diagonal edges (|O_ij| > EDGE_TOL, counted once)."""
    d = omega.diagonal()
    if not bool(d.min() > 0):
        return math.inf
    g0 = float(-torch.log(d).sum() + 0.5 * _dot(times(omega, s), omega))
    p = omega.shape[0]
    edges = (int((omega.abs() > EDGE_TOL).sum()) - p) / 2.0
    return 2.0 * n * g0 + math.log(max(n, 2)) * edges


def sample_covariance(x: torch.Tensor) -> torch.Tensor:
    """S = X^T X / n, symmetrized."""
    s = (x.T @ x) / x.shape[0]
    return 0.5 * (s + s.T)
