"""Backend registry for the ``repro_torch.estimator`` facade.

Port of ``repro.estimator.backends``.  A backend is a callable

    backend(problem, penalty, config, omega0=None) -> FitReport

registered under a name.  Three ship:

  ``reference``    the single-device solve (``core.prox.solve_reference``)
                   on the configured device;
  ``distributed``  the 1.5D solve (``core.distributed``) over the process
                   group's ranks, called on every rank (one process
                   outside a group: the reference's one-device mesh);
  ``auto``         consults the cost model for the variant and the
                   replication factors, then runs ``reference`` at world
                   size 1 and ``distributed`` above it.

The problem's data, the iterates and every reduction stay on the device;
only scalars come to the host.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..comm.grid import Grid1p5D
from ..comm.group import world_size
from ..core import distributed as dist
from ..core import matops, prox
from ..core.costmodel import (H100, ProblemShape, crossover_density,
                              enumerate_configs, tune)
from ..core.distributed import estimate_density
from ..core.penalty import PenaltySpec, as_penalty, penalty_value
from ..device import resolve_device
from .config import SolverConfig
from .report import FitReport

#: |entry| below this counts as a structural zero when observing density
NNZ_TOL = 1e-8

#: default block-density threshold for sparse_matmul="on"
DEFAULT_SPARSE_THRESHOLD = 0.25

#: relative asymmetry above this rejects an input covariance
SYMMETRY_RTOL = 1e-6


def _require_finite(name: str, arr: torch.Tensor) -> None:
    if not bool(torch.isfinite(arr).all()):
        raise ValueError(
            f"{name} contains NaN/Inf; refusing to fit (a non-finite input "
            f"silently produces a garbage estimate — clean or impute the "
            f"data first)")


def _require_symmetric(s: torch.Tensor) -> None:
    if s.numel() == 0:
        return
    scale, asym = torch.stack([s.abs().max(),
                               (s - s.T).abs().max()]).tolist()
    if asym > SYMMETRY_RTOL * max(scale, 1.0):
        raise ValueError(
            f"s must be symmetric: max |s - s^T| = {asym:.3e} at scale "
            f"{scale:.3e} — pass a genuine Gram/covariance")


class Problem(NamedTuple):
    """Input data for one estimation problem (x or s, maybe both), as
    tensors on the solve's device."""
    x: torch.Tensor | None      # (n, p) observations
    s: torch.Tensor | None      # (p, p) sample covariance
    n: int                      # sample count
    p: int

    @staticmethod
    def from_data(x=None, s=None, n_samples: int | None = None,
                  device=None) -> "Problem":
        """Validate and move the data to ``device`` (see
        :func:`repro_torch.device.resolve_device`)."""
        if x is None and s is None:
            raise ValueError("pass x (n, p) or s (p, p)")
        if n_samples is not None and (not isinstance(n_samples, (int,
                np.integer)) or n_samples < 1):
            raise ValueError(f"n_samples must be a positive int, got "
                             f"{n_samples!r}")
        dev = resolve_device(device)
        if x is not None:
            x = torch.as_tensor(x, device=dev)
            if x.ndim != 2:
                raise ValueError(f"x must be 2-D (n, p), got shape "
                                 f"{tuple(x.shape)}")
            _require_finite("x", x)
        if s is not None:
            s = torch.as_tensor(s, device=dev)
            if s.ndim != 2 or s.shape[0] != s.shape[1]:
                raise ValueError(f"s must be square (p, p), got "
                                 f"{tuple(s.shape)}")
            _require_finite("s", s)
            _require_symmetric(s)
        if x is not None and s is not None and x.shape[1] != s.shape[0]:
            raise ValueError(
                f"x has p={x.shape[1]} columns but s is {tuple(s.shape)}")
        p = (x if x is not None else s).shape[-1]
        n = x.shape[0] if x is not None else (n_samples or p)
        return Problem(x=x, s=s, n=int(n), p=int(p))

    def cov(self) -> torch.Tensor:
        """The (p, p) sample covariance, formed on demand."""
        if self.s is not None:
            return self.s
        return (self.x.T @ self.x) / self.n


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

BackendFn = Callable[..., FitReport]

_REGISTRY: dict[str, BackendFn] = {}


def register_backend(name: str, fn: BackendFn, *,
                     overwrite: bool = False) -> None:
    if not overwrite and name in _REGISTRY:
        raise ValueError(f"backend {name!r} already registered")
    _REGISTRY[name] = fn


def get_backend(name: str) -> BackendFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; available: {available_backends()}"
        ) from None


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _cast(arr: torch.Tensor, config: SolverConfig) -> torch.Tensor:
    if config.dtype is None:
        return arr
    return arr.to(getattr(torch, config.dtype))


def observed_nnz_per_row(omega: torch.Tensor) -> float:
    """Average nonzeros per row of an iterate (the cost model's ``d``)."""
    om = torch.as_tensor(omega)
    return max(1.0, int((om.abs() > NNZ_TOL).sum()) / om.shape[0])


def _problem_shape(problem: Problem, lam1: float,
                   omega0=None) -> ProblemShape:
    """Cost-model shape; a warm start's OBSERVED density replaces the
    static prior."""
    if omega0 is not None:
        d = observed_nnz_per_row(omega0)
    else:
        d = estimate_density(problem.p, problem.n, lam1)
    return ProblemShape(p=problem.p, n=problem.n, d=d)


def _matmul_policy(config: SolverConfig, p: int,
                   m: int) -> matops.MatmulPolicy | None:
    """Resolve the config's sparse_matmul knobs into a routing policy for
    an Omega-side product with ``m`` output columns."""
    mode = config.sparse_matmul
    if mode == "off":
        return None
    if mode == "on":
        thr = (config.sparse_threshold if config.sparse_threshold is not None
               else DEFAULT_SPARSE_THRESHOLD)
    else:  # auto
        thr = crossover_density(p, m, config.sparse_block)
        if config.sparse_threshold is not None:
            thr = min(thr, config.sparse_threshold)
    if thr <= 0.0:
        return None
    return matops.MatmulPolicy(mode, config.sparse_block, float(thr))


def _variant_candidates(problem: Problem, config: SolverConfig) -> tuple:
    if config.variant != "auto":
        return (config.variant,)
    return ("cov", "obs") if problem.x is not None else ("cov",)


def _check_grid(variant: str, c_x: int, c_omega: int,
                n_devices: int) -> tuple[str, int, int]:
    if variant == "cov" and c_x != c_omega:
        raise ValueError(
            f"Cov keeps Omega in the X-like layout, so c_x must equal "
            f"c_omega (got c_x={c_x}, c_omega={c_omega})")
    if c_x * c_omega > n_devices or n_devices % (c_x * c_omega):
        raise ValueError(
            f"replication c_x*c_omega={c_x * c_omega} must divide "
            f"n_devices={n_devices} (got c_x={c_x}, c_omega={c_omega})")
    return variant, c_x, c_omega


def _resolve_variant_only(problem: Problem, lam1: float,
                          config: SolverConfig, omega0=None) -> str:
    """Variant for the single-device engine (replication moot)."""
    if config.variant != "auto":
        return config.variant
    best = tune(_problem_shape(problem, lam1, omega0), 1,
                variants=_variant_candidates(problem, config))
    return best.variant


def _resolve_variant(problem: Problem, lam1: float, config: SolverConfig,
                     n_devices: int, omega0=None) -> tuple[str, int, int]:
    """Pin down (variant, c_x, c_omega) for a distributed solve.

    User-pinned values are validated (raising on an infeasible grid, never
    silently overridden); anything left open is chosen by the cost model
    (the port's H100 constants), enumerating only combinations consistent
    with the pins and with the layout constraints (Cov needs c_x ==
    c_omega; the product must divide the process count)."""
    if config.variant != "auto" and config.c_x and config.c_omega:
        return _check_grid(config.variant, config.c_x, config.c_omega,
                           n_devices)
    variants = _variant_candidates(problem, config)
    if n_devices == 1:
        if config.variant != "auto":
            return _check_grid(config.variant, config.c_x or 1,
                               config.c_omega or 1, n_devices)
        best = tune(_problem_shape(problem, lam1, omega0), 1, H100,
                    variants)
        return _check_grid(best.variant, config.c_x or 1,
                           config.c_omega or 1, n_devices)
    cands = [
        cb for cb in enumerate_configs(_problem_shape(problem, lam1, omega0),
                                       n_devices, H100, variants)
        if (config.c_x is None or cb.c_x == config.c_x)
        and (config.c_omega is None or cb.c_omega == config.c_omega)
        and n_devices % (cb.c_x * cb.c_omega) == 0
        and (cb.variant != "cov" or cb.c_x == cb.c_omega)
    ]
    if not cands:
        raise ValueError(
            f"no feasible (variant, c_x, c_omega) for n_devices={n_devices} "
            f"with variant={config.variant!r} c_x={config.c_x} "
            f"c_omega={config.c_omega}")
    best = min(cands, key=lambda cb: cb.total)
    return _check_grid(best.variant, best.c_x, best.c_omega, n_devices)


def _report(res, *, lam1, lam2, wall, backend, variant,
            config: SolverConfig, penalty: PenaltySpec, c_x: int = 1,
            c_omega: int = 1, n_devices: int = 1) -> FitReport:
    """The report of one solve.  The nnz and block-occupancy scan of the
    estimate runs on its device; only scalars come back."""
    om = res.omega
    p = om.shape[0]
    nz = om.abs() > NNZ_TOL
    bs = config.sparse_block
    occ = matops.block_mask(nz, bs)
    nnz, n_occ = torch.stack([nz.sum(), (occ > 0).sum()]).tolist()
    g = res.g_final
    return FitReport(
        omega=om,
        lam1=float(lam1), lam2=float(lam2),
        iters=int(res.iters), ls_total=int(res.ls_total),
        converged=bool(res.converged),
        stalled=bool(res.stalled),
        objective=g + penalty_value(penalty, om),
        objective_smooth=g,
        penalty=penalty.label(),
        wall_time_s=float(wall),
        backend=backend, variant=variant,
        c_x=int(c_x), c_omega=int(c_omega), n_devices=int(n_devices),
        nnz_per_row=max(1.0, nnz / p),
        block_density=n_occ / occ.numel(),
        sparse_matmul=config.sparse_matmul,
        device=str(om.device),
    )


# ---------------------------------------------------------------------------
# built-in backends
# ---------------------------------------------------------------------------

def reference_backend(problem: Problem, penalty, config: SolverConfig,
                      omega0=None) -> FitReport:
    """Single-device solve; the workhorse of warm-started paths."""
    spec = as_penalty(penalty)
    lam1 = float(spec.lam1)
    variant = _resolve_variant_only(problem, lam1, config, omega0)
    if variant == "cov":
        data = _cast(problem.cov(), config)
    else:
        if problem.x is None:
            raise ValueError("Obs variant requires the data matrix x")
        data = _cast(problem.x, config)
    policy = _matmul_policy(
        config, problem.p, problem.p if variant == "cov" else problem.n)
    res, wall = _timed(lambda: prox.solve_reference(
        data, penalty=spec, omega0=omega0, variant=variant,
        tol=config.tol, max_iters=config.max_iters, max_ls=config.max_ls,
        warm_start_tau=config.warm_start_tau,
        tau_schedule=config.tau_schedule, sparse_matmul=policy,
        use_kernels=config.use_pallas), data.device)
    return _report(res, lam1=lam1, lam2=float(spec.lam2), wall=wall,
                   backend="reference", variant=variant, config=config,
                   penalty=spec)


def _timed(fn, device: torch.device):
    """``fn()`` and its host wall, ending in a device sync on the card."""
    if device.type == "cuda":
        # a float32 solve keeps full float32 products (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    res = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return res, time.perf_counter() - t0


def distributed_backend(problem: Problem, penalty, config: SolverConfig,
                        omega0=None) -> FitReport:
    """1.5D solve over the process group's ranks (``config.n_devices``,
    by default the world size), called on every rank; each rank gets the
    whole estimate."""
    spec = as_penalty(penalty)
    lam1 = float(spec.lam1)
    n_dev = config.n_devices or world_size()
    variant, c_x, c_omega = _resolve_variant(problem, lam1, config, n_dev,
                                             omega0)
    grid = Grid1p5D(n_dev, c_x, c_omega)
    if variant != "cov" and problem.x is None:
        raise ValueError("Obs variant requires the data matrix x")
    policy = _matmul_policy(
        config, problem.p, problem.p if variant == "cov" else problem.n)
    data = _cast(problem.cov() if variant == "cov" else problem.x, config)
    fit = dist.fit_cov if variant == "cov" else dist.fit_obs
    res, wall = _timed(lambda: fit(
        data, penalty=spec, grid=grid, tol=config.tol,
        max_iters=config.max_iters, max_ls=config.max_ls,
        warm_start_tau=config.warm_start_tau, use_pallas=config.use_pallas,
        omega0=omega0, sparse_matmul=policy), data.device)
    return _report(res, lam1=lam1, lam2=float(spec.lam2), wall=wall,
                   backend="distributed", variant=res.variant,
                   config=config, penalty=spec, c_x=grid.c_x,
                   c_omega=grid.c_omega, n_devices=n_dev)


def auto_backend(problem: Problem, penalty, config: SolverConfig,
                 omega0=None) -> FitReport:
    """Cost-model dispatch (the paper's decision procedure): resolve the
    variant and replication with the cost model, then run the reference
    engine at world size 1 or the distributed engine above it."""
    spec = as_penalty(penalty)
    n_dev = config.n_devices or world_size()
    variant, c_x, c_omega = _resolve_variant(
        problem, float(spec.lam1), config, n_dev, omega0)
    pinned = config.replace(variant=variant, c_x=c_x, c_omega=c_omega)
    if n_dev == 1:
        return reference_backend(problem, spec, pinned, omega0)
    return distributed_backend(problem, spec, pinned, omega0)


register_backend("reference", reference_backend)
register_backend("distributed", distributed_backend)
register_backend("auto", auto_backend)
