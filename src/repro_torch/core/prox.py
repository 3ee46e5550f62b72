"""Proximal gradient driver for CONCORD/PseudoNet (paper Algorithms 1-3).

Port of ``repro.core.prox``.  The loop is generic over a ``VariantOps``
bundle, with the reference's op signatures:

    aux_of(omega, data[, mask]) -> aux     cov: W = Omega @ S
                                           obs: Y = Omega @ X^T
    g_of(omega, aux, data)     -> scalar   smooth objective (+inf when a
                                           diagonal entry is <= 0)
    grad_of(omega, aux, data)  -> grad     once per outer iteration
    dot(a, b)                  -> scalar   <A, B>
    prox(z, penalty, tau, data) -> array   prox of tau*penalty, diag exempt

and the optional sparsity-aware trio ``prox_stats`` (prox + the block-
occupancy mask of the candidate), ``mask_of`` and ``density_of``, and the
optional sparse trial

    prox_trial(omega, grad, penalty, tau, data)
        -> (cand, mask, <d, d>, <d, grad>, ||cand||^2),   d = cand - omega

which the single-device variants give (for the soft-threshold family
under kernels, one pass of the fused prox kernel's trial entry; else z,
the prox and the inner products as plain ops).  With it, ``g_of`` takes
a fourth argument, ||Omega||_F^2, for its ridge term.

Both loops are Python loops.  A dense trial is :func:`ls_trial`, the
reference's factored trial (``z = omega - tau * grad`` as two ops, the
same acceptance test), shared verbatim with the batched engine
(``core.batch``), which runs it on lane-stacked (C, p, p) iterates with
per-lane (C,) step sizes.  The host learns what it must branch on with
as few syncs as it can: the occupied-block count of the candidate before
its product (sparse mode only), then the acceptance flag and the step
norms in ONE ``tolist()``.  There is one problem per call, so the
reference's vmap lane-freezing selects are identities and are gone.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from ..census import host_sync, span
from ..kernels import ops as kops
from . import matops
from .objective import dot, gradient_from_w, smooth_objective_cov, \
    smooth_objective_obs
from .penalty import PenaltySpec, lane_view, normalize_penalty


class VariantOps(NamedTuple):
    aux_of: Callable
    g_of: Callable
    grad_of: Callable
    dot: Callable
    prox: Callable
    prox_stats: Callable | None = None    # enables the block-sparse path
    mask_of: Callable | None = None
    density_of: Callable | None = None
    prox_trial: Callable | None = None    # a whole sparse trial


@dataclass(frozen=True)
class ProxResult:
    """One solve's result, in Python scalars; a batched solve
    (``core.batch``) returns the same record with a leading (B,) axis on
    every field, as tensors."""
    omega: torch.Tensor
    iters: int              # outer proximal-gradient iterations taken (s)
    ls_total: int           # total line-search trials (s*t)
    converged: bool         # genuine delta < tol exit (never on a stall)
    g_final: float
    delta_final: float
    stalled: bool = False   # line search exhausted max_ls without
                            # accepting a step; iterate unchanged
    block_density: float = 1.0  # observed final block density (1.0 dense)


def guard_nonpos_diag(g: torch.Tensor, min_diag: torch.Tensor):
    """+inf objective if any diagonal entry is non-positive (log barrier)."""
    bad = (min_diag <= 0.0) | torch.isnan(g)
    return torch.where(bad, torch.full_like(g, math.inf), g)


# ---------------------------------------------------------------------------
# line-search step-size schedules
# ---------------------------------------------------------------------------

#: "restart" (tau_init every outer iteration, the paper), "warm"
#: (min(2 * last accepted tau, tau_init)), "greedy" (first trial
#: tau_init/4, later ones grow the accepted tau by 1.3x)
TAU_SCHEDULES = ("restart", "warm", "greedy")

GREEDY_TAU_GROWTH = 1.3
GREEDY_TAU_FIRST = 0.25


def resolve_tau_schedule(tau_schedule: str | None,
                         warm_start_tau: bool) -> str:
    """Canonical schedule name; ``None`` keeps the legacy bool semantics."""
    if tau_schedule is None:
        return "warm" if warm_start_tau else "restart"
    if tau_schedule not in TAU_SCHEDULES:
        raise ValueError(f"tau_schedule must be one of {TAU_SCHEDULES} or "
                         f"None, got {tau_schedule!r}")
    return tau_schedule


def tau_first(schedule: str, tau_init: float) -> float:
    """First-ever trial step size (outer step 0) under a schedule."""
    return GREEDY_TAU_FIRST * tau_init if schedule == "greedy" else tau_init


def tau_start(schedule: str, step: int, tau_prev: float,
              tau_init: float) -> float:
    """First-trial step size of outer iteration ``step``; ``tau_prev`` is
    the tau the previous line search ended at."""
    if schedule == "restart":
        return tau_init
    if step == 0:
        return tau_first(schedule, tau_init)
    growth = 2.0 if schedule == "warm" else GREEDY_TAU_GROWTH
    return min(growth * tau_prev, tau_init)


def tau_start_lanes(schedule: str, step: torch.Tensor,
                    tau_prev: torch.Tensor, tau_init: float) -> torch.Tensor:
    """:func:`tau_start` on per-lane (C,) tensors (``step`` the lanes'
    outer-iteration counters, ``tau_prev`` their last trial step sizes),
    on the lanes' device: the batched engine's form, with no host sync."""
    if schedule == "restart":
        return torch.full_like(tau_prev, tau_init)
    growth = 2.0 if schedule == "warm" else GREEDY_TAU_GROWTH
    return torch.where(step > 0,
                       torch.clamp_max(growth * tau_prev, tau_init),
                       torch.full_like(tau_prev,
                                       tau_first(schedule, tau_init)))


def ls_trial(ops: VariantOps, data, penalty, omega, grad, g_val, tau):
    """One backtracking trial at step size ``tau`` (dense product path).

    Returns ``(cand, aux_c, g_c, dot_dd, ok)``: the prox candidate, its
    aux product and smooth objective, the squared step norm
    ``<cand - omega, cand - omega>`` and the sufficient-decrease
    acceptance.  ``tau`` is a float for one problem; on lane-stacked
    (C, p, p) iterates it is a (C,) tensor and ``ops`` reduce per lane."""
    z = omega - lane_view(tau, omega) * grad
    cand = ops.prox(z, penalty, tau, data)
    del z
    aux_c = ops.aux_of(cand, data)
    g_c = ops.g_of(cand, aux_c, data)
    diff = cand - omega
    dot_dd = ops.dot(diff, diff)
    rhs = g_val + ops.dot(diff, grad) + dot_dd / (2.0 * tau)
    return cand, aux_c, g_c, dot_dd, g_c <= rhs


def prox_gradient(
    omega0: torch.Tensor,
    data,
    ops: VariantOps,
    *,
    penalty: PenaltySpec | None = None,
    lam1: float | None = None,
    tol: float = 1e-5,
    max_iters: int = 500,
    max_ls: int = 30,
    tau_init: float = 1.0,
    warm_start_tau: bool = False,
    tau_schedule: str | None = None,
) -> ProxResult:
    """Run the CONCORD/PseudoNet proximal gradient method.

    ``penalty`` enters only through ``ops.prox``/``ops.prox_stats``/
    ``ops.prox_trial``; the legacy ``lam1=`` float builds the equivalent
    l1 spec."""
    if penalty is None:
        if lam1 is None:
            raise TypeError("prox_gradient needs penalty= (or the legacy "
                            "lam1= float)")
        penalty = PenaltySpec("l1", lam1)
    elif lam1 is not None:
        raise ValueError("pass either penalty= or lam1=, not both")
    schedule = resolve_tau_schedule(tau_schedule, warm_start_tau)
    sparse = ops.prox_stats is not None
    own_trial = ops.prox_trial is not None
    omega = omega0
    mask = ops.mask_of(omega, data) if sparse else None
    aux = ops.aux_of(omega, data, mask) if sparse else ops.aux_of(omega, data)
    if own_trial:
        # ||Omega||^2 of the start; each accepted trial brings its own
        norm_sq = ops.dot(omega, omega)
        g_val = ops.g_of(omega, aux, data, norm_sq)
    else:
        g_val = ops.g_of(omega, aux, data)

    step, ls_total = 0, 0
    delta, tau_prev, stalled = math.inf, tau_init, False
    while step < max_iters and delta >= tol:
        grad = ops.grad_of(omega, aux, data)
        if not own_trial:
            norm_sq = ops.dot(omega, omega)
        tau = tau_start(schedule, step, tau_prev, tau_init)
        trials = 0
        while True:
            if trials:
                tau *= 0.5
            with span("ls_trial"):
                if own_trial:
                    cand, mask_c, dot_dd, dot_dg, nn_c = ops.prox_trial(
                        omega, grad, penalty, tau, data)
                    aux_c = ops.aux_of(cand, data, mask_c)
                    g_c = ops.g_of(cand, aux_c, data, nn_c)
                    ok_t = g_c <= g_val + dot_dg + dot_dd / (2.0 * tau)
                elif sparse:                # the distributed solver's ops
                    z = omega - tau * grad
                    cand, mask_c = ops.prox_stats(z, penalty, tau, data)
                    del z
                    aux_c = ops.aux_of(cand, data, mask_c)
                    g_c = ops.g_of(cand, aux_c, data)
                    diff = cand - omega
                    dot_dd = ops.dot(diff, diff)
                    rhs = g_val + ops.dot(diff, grad) + dot_dd / (2.0 * tau)
                    ok_t = g_c <= rhs
                    del diff
                else:
                    cand, aux_c, g_c, dot_dd, ok_t = ls_trial(
                        ops, data, penalty, omega, grad, g_val, tau)
                    mask_c = None
                # the trial's own host sync: acceptance + step norms
                with host_sync("core/prox.py:prox_gradient"):
                    ok, dd, nn = torch.stack([  # ca: allow=CA106 (the trial's sync)
                        ok_t.to(dot_dd.dtype), dot_dd, norm_sq]).tolist()
            trials += 1
            if ok or trials >= max_ls:
                break
        accepted = bool(ok)
        ls_total += trials
        tau_prev = tau
        step += 1
        stalled = not accepted
        if accepted:
            omega, aux, mask, g_val = cand, aux_c, mask_c, g_c
            if own_trial:
                norm_sq = nn_c
            delta = math.sqrt(dd) / max(1.0, math.sqrt(nn))
        else:
            # keep the old iterate and STALL: delta is zeroed so the loop
            # exits, and `stalled` records that this was not convergence
            delta = 0.0
        del cand, aux_c, mask_c, grad

    density = 1.0
    if sparse:
        density_of = ops.density_of or matops.block_density
        with host_sync("core/prox.py:prox_gradient"):
            density = float(density_of(mask))
    with host_sync("core/prox.py:prox_gradient"):
        g_final = float(g_val)
    return ProxResult(
        omega=omega, iters=step, ls_total=ls_total,
        converged=(delta < tol) and not stalled,
        g_final=g_final, delta_final=float(delta), stalled=stalled,
        block_density=density)


# ---------------------------------------------------------------------------
# single-device variants
# ---------------------------------------------------------------------------

def _ref_prox(z, pen, tau, data):
    return pen.prox(z, tau)


def _ref_sparse_ops(policy: matops.MatmulPolicy, use_kernels: bool):
    """(prox_stats, mask_of, density_of, prox_trial) for the single-device
    variants.

    With ``use_kernels``, a soft-threshold trial is one launch of the
    fused prox kernel's trial entry (span ``prox.fused_trial``): the
    occupancy mask is harvested from its per-tile nnz counts, and the
    kernel derives the diagonal from its indices, so no p x p identity is
    built.  Every other trial (SCAD/MCP, or no kernels) takes the plain
    prox + one mask pass, and the inner products as BLAS dots."""
    bs = policy.block_size

    def prox_stats(z, pen, tau, data):
        out = pen.prox(z, tau)
        return out, matops.block_mask(out, bs)

    def prox_trial(omega, grad, pen, tau, data):
        if use_kernels and pen.kernel_ok:
            with span("prox.fused_trial"):
                cand, dd, dg, nn, bnnz = kops.fused_prox_trial(
                    omega, grad, tau, tau * pen.lam1, weights=pen.weights,
                    block=(bs, bs))
            return cand, (bnnz > 0).to(matops.MASK_DTYPE), dd, dg, nn
        z = omega - tau * grad
        cand, mask = prox_stats(z, pen, tau, data)
        del z
        diff = cand - omega
        dd, dg = dot(diff, diff), dot(diff, grad)
        del diff
        return cand, mask, dd, dg, dot(cand, cand)

    def mask_of(omega, data):
        return matops.block_mask(omega, bs)

    return prox_stats, mask_of, matops.block_density, prox_trial


def _g_guarded(g, omega):
    return guard_nonpos_diag(g, omega.diagonal().min())


def cov_ops(sparse_matmul: matops.MatmulPolicy | None = None,
            use_kernels: bool = False) -> VariantOps:
    """Cov variant: data = {'s': S, 'lam2': lam2}."""
    policy = sparse_matmul

    def aux_of(omega, data, mask=None):
        return matops.matmul(omega, data["s"], mask=mask, policy=policy)

    def g_of(omega, w, data, norm_sq=None):
        return _g_guarded(smooth_objective_cov(omega, w, data["lam2"],
                                               norm_sq), omega)

    def grad_of(omega, w, data):
        return gradient_from_w(omega, w, data["lam2"])

    if policy is None or not policy.enabled:
        return VariantOps(aux_of, g_of, grad_of, dot, _ref_prox)
    return VariantOps(aux_of, g_of, grad_of, dot, _ref_prox,
                      *_ref_sparse_ops(policy, use_kernels))


def obs_ops(sparse_matmul: matops.MatmulPolicy | None = None,
            use_kernels: bool = False) -> VariantOps:
    """Obs variant: data = {'x': X, 'xt': X^T (contiguous), 'lam2': lam2};
    S is never formed.  X^T is kept contiguous once per solve so the
    block-sparse kernel reads it row-major on every trial."""
    policy = sparse_matmul

    def aux_of(omega, data, mask=None):
        return matops.matmul(omega, data["xt"], mask=mask, policy=policy)

    def g_of(omega, y, data, norm_sq=None):
        g = smooth_objective_obs(omega, y, data["x"].shape[0], data["lam2"],
                                 norm_sq)
        return _g_guarded(g, omega)

    def grad_of(omega, y, data):
        x = data["x"]
        with span("grad.obs"):
            z = (y @ x) / x.shape[0]          # Z = Omega S
        return gradient_from_w(omega, z, data["lam2"])

    if policy is None or not policy.enabled:
        return VariantOps(aux_of, g_of, grad_of, dot, _ref_prox)
    return VariantOps(aux_of, g_of, grad_of, dot, _ref_prox,
                      *_ref_sparse_ops(policy, use_kernels))


def _on_device(spec: PenaltySpec, like: torch.Tensor) -> PenaltySpec:
    """The spec with its weight matrix moved to the solve's device and
    dtype once, instead of once per trial."""
    if spec.weights is None:
        return spec
    w = torch.as_tensor(spec.weights, dtype=like.dtype, device=like.device)
    p = like.shape[-1]
    if tuple(w.shape) != (p, p):
        raise ValueError(
            f"penalty weights shape {tuple(w.shape)} must match the "
            f"problem dimension ({p}, {p})")
    return dataclasses.replace(spec, weights=w.contiguous())


def solve_reference(
    s_or_x: torch.Tensor,
    lam1: float | None = None,
    lam2: float = 0.0,
    *,
    penalty: PenaltySpec | str | None = None,
    omega0: torch.Tensor | None = None,
    variant: str = "cov",
    tol: float = 1e-5,
    max_iters: int = 500,
    max_ls: int = 30,
    warm_start_tau: bool = False,
    tau_schedule: str | None = None,
    sparse_matmul: matops.MatmulPolicy | None = None,
    use_kernels: bool = False,
) -> ProxResult:
    """Single-device CONCORD/PseudoNet solve on ``s_or_x``'s device.

    variant='cov' expects S, 'obs' expects X; ``omega0`` warm-starts the
    iterates (default: the identity).  ``sparse_matmul`` routes the
    Omega-side product through the block-sparse dispatch below the
    policy's density; ``use_kernels`` takes the prox and the occupancy
    harvest from the fused prox kernel (the reference's ``use_pallas``).
    """
    spec = _on_device(normalize_penalty(penalty, lam1, lam2), s_or_x)
    lam2_v = float(spec.lam2)
    if variant == "cov":
        data = {"s": s_or_x.contiguous(), "lam2": lam2_v}
        ops = cov_ops(sparse_matmul, use_kernels)
    elif variant == "obs":
        data = {"x": s_or_x, "xt": s_or_x.T.contiguous(), "lam2": lam2_v}
        ops = obs_ops(sparse_matmul, use_kernels)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    p = s_or_x.shape[-1]
    if omega0 is None:
        omega0 = torch.eye(p, dtype=s_or_x.dtype, device=s_or_x.device)
    else:
        omega0 = torch.as_tensor(omega0, dtype=s_or_x.dtype,
                                 device=s_or_x.device).contiguous()
    return prox_gradient(
        omega0, data, ops, penalty=spec, tol=tol, max_iters=max_iters,
        max_ls=max_ls, warm_start_tau=warm_start_tau,
        tau_schedule=tau_schedule)


# ---------------------------------------------------------------------------
# analysis manifest (repro_torch.analysis.dispatchpass)
# ---------------------------------------------------------------------------

def _analysis_cov(p: int, device) -> torch.Tensor:
    return (torch.eye(p, dtype=torch.float64, device=device)
            + 0.05 * torch.ones((p, p), dtype=torch.float64, device=device))


def _analysis_solve(device):
    return {"fn": solve_reference, "args": (_analysis_cov(8, device), 0.1),
            "kwargs": dict(tol=1e-4, max_iters=8, max_ls=8)}


def _analysis_solve_sparse(device):
    """The block-sparse trial at p = 64, block 8: a banded S keeps the
    iterate's 8 diagonal blocks occupied (density 1/8 under the 0.5
    threshold), so on the card every trial runs the fused prox kernel and
    the block-sparse product's mask entry."""
    p = 64
    idx = torch.arange(p, device=device)
    band = (idx[:, None] - idx[None, :]).abs() <= 1
    s = torch.eye(p, dtype=torch.float64, device=device) + 0.3 * band
    policy = matops.MatmulPolicy(mode="on", block_size=8, threshold=0.5)
    return {"fn": solve_reference, "args": (s, 0.1),
            "kwargs": dict(tol=1e-4, max_iters=8, max_ls=8,
                           sparse_matmul=policy, use_kernels=True)}


#: the sequential reference solve (the oracle every other layer matches),
#: dense and through the block-sparse trial with the kernels
ANALYSIS_ENTRIES = [
    {"name": "core.prox.solve_reference",
     "path": "src/repro_torch/core/prox.py", "build": _analysis_solve},
    {"name": "core.prox.solve_reference[sparse]",
     "path": "src/repro_torch/core/prox.py",
     "build": _analysis_solve_sparse},
]
