"""CONCORD / PseudoNet objective, gradient and proximal operator in torch.

The port of ``repro.core.objective``; the formulas are the same:

    g(Omega) = -sum_i log(omega_ii) + 1/2 tr(Omega S Omega) + lam2/2 ||Omega||_F^2
    h(Omega) = lam1 * ||Omega_X||_1           (off-diagonal l1)
    grad g   = -Omega_D^{-1} + 1/2 (W + W^T) + lam2 * Omega,   W = Omega S

Inner products go through :func:`dot`, one BLAS dot over the flattened
operands, so an objective evaluation at p = 16384 allocates no p x p
temporary (``(a * b).sum()`` would write and read one 2 GB matrix in
float64).  The summation order therefore differs from XLA's reduction;
the parity tests hold the port to the reference at float64 tolerance.
"""
from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<A, B> = sum_ij a_ij b_ij as a 0-d tensor on the operands' device."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def soft_threshold(z: torch.Tensor, alpha) -> torch.Tensor:
    """Elementwise soft-thresholding S_alpha(z) (paper eq. (2))."""
    return torch.sign(z) * torch.clamp_min(torch.abs(z) - alpha, 0.0)


def prox_l1_offdiag(z: torch.Tensor, alpha) -> torch.Tensor:
    """Prox of alpha*||Z_X||_1: soft-threshold off-diagonal, keep diagonal."""
    out = soft_threshold(z, alpha)
    out.diagonal().copy_(z.diagonal())
    return out


def offdiag_l1(omega: torch.Tensor) -> torch.Tensor:
    return torch.abs(omega).sum() - torch.abs(omega.diagonal()).sum()


def smooth_objective_cov(omega: torch.Tensor, w: torch.Tensor,
                         lam2, norm_sq=None) -> torch.Tensor:
    """g(Omega) given W = Omega @ S (tr(Omega S Omega) = <W, Omega>).

    ``norm_sq`` is ||Omega||_F^2 where the caller already has it (the
    fused trial's); else it is taken here."""
    logdet_term = -torch.log(omega.diagonal()).sum()
    quad = 0.5 * dot(w, omega)
    ridge = 0.5 * lam2 * (dot(omega, omega) if norm_sq is None else norm_sq)
    return logdet_term + quad + ridge


def smooth_objective_obs(omega: torch.Tensor, y: torch.Tensor, n: int,
                         lam2, norm_sq=None) -> torch.Tensor:
    """g(Omega) given Y = Omega @ X^T (unnormalized): tr(Omega S Omega)
    = ||Y||_F^2 / n; ``norm_sq`` as in :func:`smooth_objective_cov`."""
    logdet_term = -torch.log(omega.diagonal()).sum()
    quad = 0.5 * dot(y, y) / n
    ridge = 0.5 * lam2 * (dot(omega, omega) if norm_sq is None else norm_sq)
    return logdet_term + quad + ridge


def gradient_from_w(omega: torch.Tensor, w: torch.Tensor,
                    lam2) -> torch.Tensor:
    """grad g = -Omega_D^{-1} + (W + W^T)/2 + lam2 * Omega.

    Built in place on one p x p buffer (plus the lam2 * Omega term) in
    the reference's association order: the diagonal correction joins the
    symmetrized W before the ridge term is added.  Lane-stacked (C, p, p)
    operands take a (C, 1, 1) ``lam2`` and transpose each lane."""
    grad = w + w.mT
    grad.mul_(0.5)
    grad.diagonal(dim1=-2, dim2=-1).sub_(
        1.0 / omega.diagonal(dim1=-2, dim2=-1))
    grad += lam2 * omega
    return grad


def full_objective_cov(omega, s, lam1, lam2):
    w = omega @ s
    return smooth_objective_cov(omega, w, lam2) + lam1 * offdiag_l1(omega)


def full_objective_obs(omega, x, lam1, lam2):
    n = x.shape[0]
    y = omega @ x.T
    return smooth_objective_obs(omega, y, n, lam2) + lam1 * offdiag_l1(omega)


def sufficient_decrease(g_new, g_old, omega_new, omega_old, grad, tau):
    """Backtracking acceptance (Algorithms 2/3 line 12).

    g(O+) <= g(O) + tr((O+ - O)^T G) + ||O+ - O||_F^2 / (2 tau)
    """
    diff = omega_new - omega_old
    rhs = g_old + dot(diff, grad) + dot(diff, diff) / (2.0 * tau)
    return g_new <= rhs
