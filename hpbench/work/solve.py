"""The least work of a whole CONCORD solve at the trials and nonzeros it
showed: Lemma 3.4 of the paper (Koanantakool et al., arXiv:1710.10769)
at one process, with the terms a fused implementation could not avoid.

Lemma 3.4 counts, for s outer iterations of t trials each and d nonzeros
per row of Omega:

  Cov:  F = 2 n p^2 + 2 d p^2 (s t + 1)
  Obs:  F = 2 n p^2 s + 2 d n p (s t + 1)

The Cov term 2 n p^2 forms S, which the benchmark does in set-up, so it
is dropped.  Bytes: every trial reads one dense (p x p) operand at least
once (S for the candidate's product in Cov; the gradient for the prox in
Obs), and an Obs trial also reads X once for Omega X^T.  Each product
(a trial's, and the first one of a solve) is counted at the solve's
final nonzeros, since the program reports no other: on a descending
path the iterates have about as many or fewer, so the count reads high,
as an upper bound would.  The Obs gradient product (Omega X^T) X once
per outer iteration is dense in any implementation.

``bic_seconds`` is the least time of the pseudo-likelihood BIC of one
path point: tr(Omega S Omega) reads S once.
"""
from __future__ import annotations

from . import WORD, least_seconds


def cov_seconds(p: int, ls_total: int, nnz: float, peaks: dict) -> float:
    trial = least_seconds(2.0 * nnz * p, WORD * float(p) * p, peaks)
    return (ls_total + 1) * trial


def obs_seconds(p: int, n: int, iters: int, ls_total: int, nnz: float,
                peaks: dict) -> float:
    gradient = least_seconds(2.0 * n * float(p) * p,
                             WORD * (2.0 * n * p + float(p) * p), peaks)
    trial = least_seconds(2.0 * nnz * n, WORD * (float(p) * p + n * p),
                          peaks)
    return iters * gradient + (ls_total + 1) * trial


def bic_seconds(p: int, nnz: float, peaks: dict) -> float:
    return least_seconds(2.0 * nnz * p, WORD * float(p) * p, peaks)
