"""Distributed HP-CONCORD drivers (paper Algorithms 2 and 3).

Port of ``repro.core.distributed``.  The reference runs the whole
proximal-gradient solve inside one ``shard_map`` over the 1.5D grid mesh;
the port runs one process per grid position (``comm.group``), and each
rank runs the port's own :func:`repro_torch.core.prox.prox_gradient` on
its local ``VariantOps``:

  Cov  (Algorithm 2) — per-rank state is an X-like column panel
    (p_pad, p_pad / n_x) of Omega.
    aux_of  : W = Omega @ S          1.5D gather-rotation of Omega
                                     (stored as the local transpose of the
                                     column panel — valid because the
                                     iterates are symmetric; this is the
                                     paper's Figure-1 "local transpose")
    grad_of : W^T via the replication-aware distributed transpose

  Obs  (Algorithm 3) — per-rank state is an Omega-like row block
    (p_pad / n_om, p_pad).
    aux_of  : Y = Omega @ X^T        1.5D reduce-rotation of X^T
    grad_of : Z = Y @ X / n          1.5D gather-rotation of X,
              Z^T via the distributed transpose
    S is never formed.

Lock step.  Every scalar that steers the loop — the objective g, the dots,
the minimum diagonal entry, the block density — comes out of an
all-reduce, so every rank takes the same branch, at the same trial, in the
same iteration, and issues the same collectives in the same order.

No collective in a rank-local branch.  Two decisions are rank-local: the
matops dispatch (dense or block-sparse, per local tile, on the host, from
the tile's own occupancy) and whether a rank's panel holds padded
diagonal entries.  Neither may post a collective, or ranks whose tiles
differ in density would issue different collectives and hang; the ring
products post theirs outside the dispatch.

Kernels per shard.  With ``use_pallas`` (the reference's name) the prox
of each rank's panel is kernel 1 with that panel's diagonal mask, which
lies off the origin (ones at (t*blk + r, r) for Cov, (r, u*blk + r) for
Obs); with a block-sparse policy its per-tile nonzero counts are the
panel's occupancy mask, and every ring round's local product goes through
kernel 2 (``core.matops``).

Padding.  The layouts need p divisible by P.  We pad to p' = pad_p(p) and
*freeze* the padded coordinates: the padded diagonal starts at 1 and its
gradient is masked to zero, off-block entries are zero and stay zero
because the padded block of S (resp. the padded columns of X) is zero, so
the real (p x p) block of every iterate is EXACTLY the unpadded iterate.
The ridge term subtracts the constant contributed by the frozen diagonal
so reported objectives match the reference solver.

Inputs and outputs.  A full ``s`` or ``x`` goes in on every rank, as in
the reference; each rank slices its own panel, and the estimate is
all-gathered to every rank.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import torch

from ..comm import matmul1p5d as mm
from ..comm import sparse1p5d as sp
from ..comm.contract import CommContract
from ..comm.grid import Grid1p5D
from ..comm.group import Comm, comm_for, world_size
from ..device import resolve_device
from ..kernels import ops as kops
from . import matops
from .costmodel import H100, Machine, ProblemShape, tune
from .objective import dot as local_dot
from .penalty import PenaltySpec, normalize_penalty
from .prox import VariantOps, guard_nonpos_diag, prox_gradient

SPEC_XCOL = mm.SPEC_XCOL
SPEC_OM = mm.SPEC_OM


class FitResult(NamedTuple):
    omega: torch.Tensor
    iters: int
    ls_total: int
    converged: bool         # genuine delta < tol exit (never set on a stall)
    g_final: float
    variant: str
    grid: Grid1p5D
    block_density: float = 1.0
    stalled: bool = False   # line search exhausted without accept


def _shard_policy(policy: matops.MatmulPolicy | None,
                  shard_shape: tuple[int, int],
                  also_divide: tuple[int, ...] = ()
                  ) -> matops.MatmulPolicy | None:
    """The policy actually usable on a per-rank Omega shard: the mask is
    rotated/sliced at block granularity inside the ring loops, so the block
    grid must tile the shard (and any ``also_divide`` slice widths) exactly;
    otherwise fall back to dense, with a warning, as the reference does."""
    if policy is None or not policy.enabled:
        return None
    bs = policy.block_size
    if any(d % bs for d in tuple(shard_shape) + tuple(also_divide)):
        warnings.warn(
            f"sparse_matmul block_size={bs} does not tile the local Omega "
            f"shard {shard_shape} (slice widths {also_divide}); falling back "
            f"to the dense path (pick a block size dividing p_pad/n_blocks)",
            stacklevel=3)
        return None
    return policy


# ---------------------------------------------------------------------------
# local-layout helpers
# ---------------------------------------------------------------------------

def _diag_block(a: torch.Tensor, lo: int, blk: int, rows: bool):
    """View of this shard's diagonal: a[lo + r, r] on an X-like column
    panel (``rows``), a[r, lo + r] on an Omega-like row block."""
    return (a[lo:lo + blk] if rows else a[:, lo:lo + blk]).diagonal()


def _eye_shard(shape, lo: int, blk: int, rows: bool, dtype, device):
    """This shard of the identity: the local panel's diagonal mask."""
    e = torch.zeros(shape, dtype=dtype, device=device)
    _diag_block(e, lo, blk, rows).fill_(1.0)
    return e


def _padded(lo: int, blk: int, p_real: int) -> list[int]:
    """Local diagonal positions r whose global index lo + r is padding."""
    return [r for r in range(blk) if lo + r >= p_real]


def _dist_sparse_ops(policy: matops.MatmulPolicy, use_kernels: bool,
                     diag_mask, psum, prox):
    """(prox_stats, mask_of, density_of) shared by the Cov and Obs drivers —
    only the diag-mask layout and the psum team differ between variants."""
    bs = policy.block_size

    def prox_stats(z, pen, tau, data):
        if use_kernels and pen.kernel_ok:
            # occupancy harvested from the fused kernel's nnz lane
            out, _, _, _, _, bnnz = kops.fused_prox_stats(
                z, diag_mask, tau * pen.lam1, weights=pen.weights,
                block=(bs, bs))
            return out, (bnnz > 0).to(matops.MASK_DTYPE)
        out = prox(z, pen, tau, data)
        return out, matops.block_mask(out, bs)

    def mask_of(omega_loc, data):
        return matops.block_mask(omega_loc, bs)

    def density_of(mask):
        # numerator and denominator both count each Omega block once per
        # partitioning team, so replication layers cancel in the ratio
        counts = psum(torch.stack([
            (mask > 0).sum().to(matops.DENSITY_DTYPE),
            torch.tensor(mask.numel(), dtype=matops.DENSITY_DTYPE,
                         device=mask.device)]))
        return counts[0] / counts[1]

    return prox_stats, mask_of, density_of


def _local_ops(comm: Comm, p_pad: int, p_real: int, lam2: float, dtype,
               *, variant: str, n: int = 0, use_kernels: bool = False,
               sparse_matmul: matops.MatmulPolicy | None = None
               ) -> VariantOps:
    """The per-rank ``VariantOps`` of one variant: the product (``aux``)
    and its gradient term differ, everything else is shared."""
    grid = comm.grid
    cov = variant == "cov"
    if cov:
        blk = p_pad // grid.n_x
        lo = comm.block_x * blk
        shape, team = (p_pad, blk), ("i", "j")
        policy = _shard_policy(sparse_matmul, shape)
    else:
        blk = p_pad // grid.n_om
        lo = comm.block_om * blk
        shape, team = (blk, p_pad), ("i", "k")
        # the reduce-flavor rotation slices Omega at blk_x granularity, so
        # the mask slice must land on block boundaries too
        policy = _shard_policy(sparse_matmul, shape,
                               also_divide=(p_pad // grid.n_x,))
    n_pad_diag = p_pad - p_real
    pads = _padded(lo, blk, p_real)
    diag_mask = _eye_shard(shape, lo, blk, cov, dtype, comm.device)

    def psum(v):
        return comm.psum(v, team)

    def diag_of(om):
        return _diag_block(om, lo, blk, cov)

    if cov:
        def aux_of(panel, data, mask=None):
            # Figure 1: local transpose converts the column panel to the
            # row block the rotation consumes (iterates are symmetric)
            if mask is None:
                return mm.omega_s_local(panel.T, data["s"], comm,
                                        canonical="xlike")
            return sp.omega_s_local_sparse(panel.T, mask.T, data["s"], comm,
                                           canonical="xlike", policy=policy)

        def quad_of(aux, om):
            return local_dot(aux, om)

        def sym_part(aux, data):
            return aux, mm.transpose_xlike_local(aux, comm)
    else:
        def aux_of(rows, data, mask=None):
            if mask is None:
                return mm.omega_xt_local(rows, data["xt"], comm)  # Y, unnorm.
            return sp.omega_xt_local_sparse(rows, mask, data["xt"], comm,
                                            policy=policy)

        def quad_of(aux, om):
            return local_dot(aux, aux)

        def sym_part(aux, data):
            z = mm.y_x_local(aux, data["x"], comm, scale=1.0 / n)
            return z, mm.transpose_omegalike_local(z, comm)

    def g_of(om, aux, data):
        diag = diag_of(om)
        sums = psum(torch.stack([
            torch.log(torch.clamp_min(diag, 1e-30)).sum(),
            quad_of(aux, om), local_dot(om, om)]))
        logdet = -sums[0]
        quad = 0.5 * sums[1] if cov else 0.5 * sums[1] / n
        ridge = 0.5 * lam2 * (sums[2] - n_pad_diag)
        g = logdet + quad + ridge
        return guard_nonpos_diag(g, comm.pmin(diag.min(), team))

    def grad_of(om, aux, data):
        a, at = sym_part(aux, data)
        grad = 0.5 * (a + at)
        d = _diag_block(grad, lo, blk, cov)
        # -inv + A on the diagonal block, in the reference's operand order
        d.copy_(-(1.0 / diag_of(om)) + d)
        grad = grad + lam2 * om
        if pads:                                  # freeze padded diagonal
            _diag_block(grad, lo, blk, cov)[pads] = 0.0
        return grad

    def dot(a, b):
        return psum(local_dot(a, b))

    def prox(z, pen, tau, data):
        if use_kernels and pen.kernel_ok:
            return kops.fused_prox_stats(z, diag_mask, tau * pen.lam1,
                                         weights=pen.weights)[0]
        return pen.prox(z, tau, diag_mask)

    if policy is None:
        return VariantOps(aux_of, g_of, grad_of, dot, prox)
    return VariantOps(aux_of, g_of, grad_of, dot, prox, *_dist_sparse_ops(
        policy, use_kernels, diag_mask, psum, prox))


def _cov_local_ops(comm: Comm, p_pad: int, p_real: int, lam2: float, dtype,
                   use_pallas: bool = False,
                   sparse_matmul: matops.MatmulPolicy | None = None
                   ) -> VariantOps:
    """Cov (Algorithm 2) on an X-like column panel."""
    return _local_ops(comm, p_pad, p_real, lam2, dtype, variant="cov",
                      use_kernels=use_pallas, sparse_matmul=sparse_matmul)


def _obs_local_ops(comm: Comm, p_pad: int, p_real: int, n: int, lam2: float,
                   dtype, use_pallas: bool = False,
                   sparse_matmul: matops.MatmulPolicy | None = None
                   ) -> VariantOps:
    """Obs (Algorithm 3) on an Omega-like row block."""
    return _local_ops(comm, p_pad, p_real, lam2, dtype, variant="obs", n=n,
                      use_kernels=use_pallas, sparse_matmul=sparse_matmul)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def _pad_square(a: torch.Tensor, p_pad: int) -> torch.Tensor:
    p = a.shape[-1]
    if p_pad == p:
        return a
    return torch.nn.functional.pad(a, (0, p_pad - p, 0, p_pad - p))


def _pad_omega0(omega0, like: torch.Tensor, p: int, p_pad: int):
    """Pad a warm-start iterate with the frozen identity diagonal so the
    padded block behaves exactly like a cold start there."""
    omega0 = torch.as_tensor(omega0, dtype=like.dtype, device=like.device)
    omega0 = _pad_square(omega0, p_pad)
    if p_pad != p:
        omega0 = omega0.clone()
        omega0.diagonal()[p:] = 1.0
    return omega0


def _shard_spec_weights(spec: PenaltySpec, like: torch.Tensor, p: int,
                        p_pad: int, comm: Comm, layout) -> PenaltySpec:
    """The weight matrix cast to the solve dtype, zero-padded to the
    grid-padded dimension (padded off-diagonal entries stay exactly zero
    whatever their weight, so the pad value is inert) and sharded like
    Omega."""
    if spec.weights is None:
        return spec
    w = torch.as_tensor(spec.weights, dtype=like.dtype, device=like.device)
    if tuple(w.shape) != (p, p):
        raise ValueError(
            f"penalty weights shape {tuple(w.shape)} must match the problem "
            f"dimension ({p}, {p})")
    return dataclasses.replace(
        spec, weights=mm.shard(_pad_square(w, p_pad), comm, layout))


#: dispatch-observer hook (``repro_torch.obs.commwatch``): when set, the
#: driver announces each solve before its loop starts and the loop's
#: result when it ends.  The observer must not post a collective or touch
#: the device: the solve itself is untouched.
_DISPATCH_OBSERVER = None


def set_dispatch_observer(observer):
    """Install ``observer`` (or None) on the driver hook; returns the
    previous observer so callers can restore it.

    ``observer.on_dispatch(variant, grid, meta)`` runs on this rank right
    before the loop, with ``meta`` = ``{"p", "p_pad", "n", "dtype",
    "sparse"}``, and returns a token; ``observer.on_result(token, res)``
    runs when the loop has ended, with its ``ProxResult`` (``iters``,
    ``ls_total``, ...), before the estimate's closing all-gather: the
    reference leaves its estimate sharded in the program's output, with
    no collective, so the gather is not part of the solve's schedule."""
    global _DISPATCH_OBSERVER
    prev = _DISPATCH_OBSERVER
    _DISPATCH_OBSERVER = observer
    return prev


def _solve(variant, data_full, lam1, lam2, *, grid, comm, tol, max_iters,
           max_ls, warm_start_tau, use_pallas, omega0, penalty,
           sparse_matmul) -> FitResult:
    dev = data_full.device
    comm = comm or comm_for(grid, dev)
    if comm.grid != grid:
        raise ValueError(f"comm is for {comm.grid}, not {grid}")
    cov = variant == "cov"
    n, p = (None, data_full.shape[0]) if cov else data_full.shape
    p_pad = grid.pad_p(p)
    dtype = data_full.dtype
    layout = SPEC_XCOL if cov else SPEC_OM
    spec = _shard_spec_weights(normalize_penalty(penalty, lam1, lam2),
                               data_full, p, p_pad, comm, layout)
    lam2_v = float(spec.lam2)
    if cov:
        s_panel = mm.shard(_pad_square(data_full, p_pad), comm, SPEC_XCOL)
        data = {"s": s_panel}
        ops = _cov_local_ops(comm, p_pad, p, lam2_v, dtype, use_pallas,
                             sparse_matmul)
        blk, lo = p_pad // grid.n_x, comm.block_x * (p_pad // grid.n_x)
        shape = (p_pad, blk)
    else:
        x = data_full
        if p_pad != p:
            x = torch.nn.functional.pad(x, (0, p_pad - p))
        x_loc = mm.shard(x, comm, SPEC_XCOL)
        data = {"x": x_loc, "xt": x_loc.T.contiguous()}
        ops = _obs_local_ops(comm, p_pad, p, n, lam2_v, dtype, use_pallas,
                             sparse_matmul)
        blk, lo = p_pad // grid.n_om, comm.block_om * (p_pad // grid.n_om)
        shape = (blk, p_pad)
    if omega0 is None:
        # cold start: each rank builds its shard of the identity (never the
        # full p_pad^2 identity)
        om0 = _eye_shard(shape, lo, blk, cov, dtype, dev)
    else:
        om0 = mm.shard(_pad_omega0(omega0, data_full, p, p_pad), comm, layout)
    obs = _DISPATCH_OBSERVER
    if obs is not None:
        token = obs.on_dispatch(variant, grid, {
            "p": p, "p_pad": p_pad, "n": n,
            "dtype": str(dtype).removeprefix("torch."),
            "sparse": ops.prox_stats is not None})
    res = prox_gradient(om0, data, ops, penalty=spec, tol=tol,
                        max_iters=max_iters, max_ls=max_ls,
                        warm_start_tau=warm_start_tau)
    if obs is not None:
        obs.on_result(token, res)
    omega = mm.unshard(res.omega, comm, layout)[:p, :p]
    return FitResult(omega, res.iters, res.ls_total, res.converged,
                     res.g_final, variant, grid, res.block_density,
                     res.stalled)


def fit_cov(
    s: torch.Tensor,
    lam1: float | None = None,
    lam2: float = 0.0,
    *,
    grid: Grid1p5D,
    comm: Comm | None = None,
    tol: float = 1e-5,
    max_iters: int = 500,
    max_ls: int = 30,
    warm_start_tau: bool = False,
    use_pallas: bool = False,
    omega0: torch.Tensor | None = None,
    penalty: PenaltySpec | str | None = None,
    sparse_matmul: matops.MatmulPolicy | None = None,
) -> FitResult:
    """Distributed Cov solve (Algorithm 2), called on every rank of the
    grid's process group.  ``s`` is the (p, p) sample covariance on this
    rank's device; ``comm`` defaults to the grid's teams on that device.
    ``omega0`` optionally warm-starts the iterates (e.g. along a lam1
    path).  ``penalty`` swaps the prox operator (``core.penalty``); a
    weighted-l1 weight matrix is sharded with the Omega panel layout.
    Legacy ``lam1``/``lam2`` floats build the equivalent l1 spec.
    ``sparse_matmul`` routes the W = Omega S rotation through the
    block-sparse local products of ``comm.sparse1p5d``."""
    if grid.c_x != grid.c_omega:
        raise ValueError("Cov keeps Omega in the X-like layout: c_x == c_omega")
    return _solve("cov", s, lam1, lam2, grid=grid, comm=comm, tol=tol,
                  max_iters=max_iters, max_ls=max_ls,
                  warm_start_tau=warm_start_tau, use_pallas=use_pallas,
                  omega0=omega0, penalty=penalty, sparse_matmul=sparse_matmul)


def fit_obs(
    x: torch.Tensor,
    lam1: float | None = None,
    lam2: float = 0.0,
    *,
    grid: Grid1p5D,
    comm: Comm | None = None,
    tol: float = 1e-5,
    max_iters: int = 500,
    max_ls: int = 30,
    warm_start_tau: bool = False,
    use_pallas: bool = False,
    omega0: torch.Tensor | None = None,
    penalty: PenaltySpec | str | None = None,
    sparse_matmul: matops.MatmulPolicy | None = None,
) -> FitResult:
    """Distributed Obs solve (Algorithm 3), called on every rank.  ``x``
    is the (n, p) data matrix on this rank's device; the rest as
    :func:`fit_cov`, with a weighted-l1 weight matrix sharded with the
    Omega row-block layout and ``sparse_matmul`` routing the
    Y = Omega X^T rotation through ``comm.sparse1p5d``."""
    return _solve("obs", x, lam1, lam2, grid=grid, comm=comm, tol=tol,
                  max_iters=max_iters, max_ls=max_ls,
                  warm_start_tau=warm_start_tau, use_pallas=use_pallas,
                  omega0=omega0, penalty=penalty, sparse_matmul=sparse_matmul)


# ---------------------------------------------------------------------------
# the cost-model-driven front door (deprecated shims, as in the reference)
# ---------------------------------------------------------------------------

def estimate_density(p: int, n: int, lam1: float) -> float:
    """Crude prior for d (avg nnz/row of the iterates) used by the tuner
    before any fit exists: heavier penalty -> sparser iterates."""
    return float(min(p, max(2.0, 0.05 * p / max(lam1, 1e-2))))


def _as_tensor(a, device):
    return None if a is None else torch.as_tensor(a, device=device)


def fit(
    x: torch.Tensor | None = None,
    s: torch.Tensor | None = None,
    *,
    lam1: float,
    lam2: float = 0.0,
    variant: str = "auto",
    n_devices: int | None = None,
    c_x: int | None = None,
    c_omega: int | None = None,
    machine: Machine | None = None,
    n_samples: int | None = None,
    device=None,
    **kw,
) -> FitResult:
    """Deprecated shim — use :mod:`repro_torch.estimator`
    (``ConcordEstimator`` or ``repro_torch.estimator.fit``), which adds
    backend selection, warm starts and fit reports on top of the same
    cost-model dispatch.

    Pass ``x`` (n, p) to allow either variant, or only ``s`` (p, p) to
    force Cov. ``c_x``/``c_omega`` pin the replication factors; otherwise
    the tuner picks them.  Runs on every rank of the process group (one
    process outside one), on ``device`` (None: the CUDA card).
    """
    warnings.warn(
        "distributed.fit is deprecated; use repro_torch.estimator."
        "ConcordEstimator or repro_torch.estimator.fit", DeprecationWarning,
        stacklevel=2)
    if x is None and s is None:
        raise ValueError("pass x or s")
    dev = resolve_device(device)
    x, s = _as_tensor(x, dev), _as_tensor(s, dev)
    P_ = n_devices or world_size()
    p = (x if x is not None else s).shape[-1]
    n = x.shape[0] if x is not None else (n_samples or p)
    m = machine or H100
    shape = ProblemShape(p=p, n=n, d=estimate_density(p, n, lam1))

    pinned_cx, pinned_co = c_x is not None, c_omega is not None
    user_pinned = pinned_cx or pinned_co
    if variant == "auto":
        variants = ("cov", "obs") if x is not None else ("cov",)
        best = tune(shape, P_, m, variants)
        variant = best.variant
        c_x = c_x if c_x is not None else best.c_x
        c_omega = c_omega if c_omega is not None else best.c_omega
    c_x = c_x or 1
    c_omega = c_omega or 1
    if variant == "cov":
        if pinned_co and c_omega != c_x:
            raise ValueError(
                f"Cov keeps Omega in the X-like layout, so c_x must equal "
                f"c_omega (got c_x={c_x}, c_omega={c_omega})")
        c_omega = c_x  # Cov keeps Omega X-like
        if c_x * c_omega > P_ or P_ % (c_x * c_omega):
            if user_pinned:
                raise ValueError(
                    f"replication c_x*c_omega={c_x * c_omega} must divide "
                    f"n_devices={P_} (got c_x={c_x}, c_omega={c_omega})")
            # the tuner's own choice made infeasible by the coercion
            c_x = c_omega = 1
        grid = Grid1p5D(P_, c_x, c_omega)
        s_mat = s if s is not None else (x.T @ x) / n
        return fit_cov(s_mat, lam1, lam2, grid=grid, **kw)
    grid = Grid1p5D(P_, c_x, c_omega)
    if x is None:
        raise ValueError("Obs variant requires the data matrix x")
    return fit_obs(x, lam1, lam2, grid=grid, **kw)


def fit_path(
    x: torch.Tensor,
    lam1_grid,
    lam2: float = 0.0,
    *,
    variant: str = "obs",
    grid: Grid1p5D | None = None,
    device=None,
    **kw,
) -> list[FitResult]:
    """Deprecated shim — use ``repro_torch.estimator.ConcordEstimator.
    fit_path``, which warm-starts consecutive path points.

    Fit a path of estimates over a lam1 grid (the paper's Section-5
    tuning-parameter sweep), coarse to fine, each point cold."""
    warnings.warn(
        "distributed.fit_path is deprecated; use "
        "repro_torch.estimator.ConcordEstimator.fit_path",
        DeprecationWarning, stacklevel=2)
    x = torch.as_tensor(x, device=resolve_device(device))
    grid = grid or Grid1p5D(world_size(), 1, 1)
    out = []
    for lam1 in sorted(lam1_grid, reverse=True):
        fn = fit_obs if variant == "obs" else fit_cov
        data = x if variant == "obs" else (x.T @ x) / x.shape[0]
        out.append(fn(data, lam1, lam2, grid=grid, **kw))
    return out


# ---------------------------------------------------------------------------
# declared collective schedule of the drivers
# ---------------------------------------------------------------------------

def _driver_contract():
    """Declared schedule of the end-to-end drivers (no volume contract —
    the outer loop's trip count is data-dependent, so bytes/invocation is
    not a static quantity here; the per-product volumes are pinned by the
    ``comm.matmul1p5d`` and ``comm.sparse1p5d`` entries instead)."""
    return CommContract(
        entry="core.distributed.fit",
        axes=("i", "j", "k"),
        kinds=("ppermute", "psum", "pmin", "all_gather", "all_to_all"),
        # the iterate/objective arithmetic is f64 by contract; the ring
        # also rotates int8 occupancy masks and reduces f32 density
        # diagnostics
        wire=("operand", "mask", "float32"),
        volume_class="per-rank driver (dynamic trip count)")


COMM_CONTRACT = {
    "fit_cov": _driver_contract(),
    "fit_obs": _driver_contract(),
}

# ---------------------------------------------------------------------------
# analysis manifest (repro_torch.analysis.dispatchpass)
# ---------------------------------------------------------------------------

def _analysis_fit_cov(device):
    p = 8
    s = (torch.eye(p, dtype=torch.float64, device=device)
         + 0.05 * torch.ones((p, p), dtype=torch.float64, device=device))
    return {"fn": fit_cov, "args": (s, 0.2),
            "kwargs": dict(grid=Grid1p5D(1, 1, 1), tol=1e-3, max_iters=4,
                           max_ls=4)}


def _analysis_fit_obs(device):
    n, p = 12, 8
    x = torch.linspace(-1.0, 1.0, n * p, dtype=torch.float64,
                       device=device).reshape(n, p)
    return {"fn": fit_obs, "args": (x, 0.2),
            "kwargs": dict(grid=Grid1p5D(1, 1, 1), tol=1e-3, max_iters=4,
                           max_ls=4)}


#: both 1.5D drivers end to end on a one-process (1, 1, 1) grid: every
#: team has one member and every collective is the identity, so the
#: iteration's dtype contract is checked without a process group
ANALYSIS_ENTRIES = [
    {"name": "core.distributed.fit_cov",
     "path": "src/repro_torch/core/distributed.py",
     "build": _analysis_fit_cov},
    {"name": "core.distributed.fit_obs",
     "path": "src/repro_torch/core/distributed.py",
     "build": _analysis_fit_obs},
]
