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

import contextlib
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..census import host_sync, span
from ..comm.grid import Grid1p5D
from ..comm.group import world_size
from ..core import distributed as dist
from ..core import matops, prox
from ..core.costmodel import (CARD_BLOCK_MODEL, H100, ProblemShape,
                              crossover_density, enumerate_configs, tune)
from ..core.distributed import estimate_density
from ..core.penalty import PenaltySpec, as_penalty, penalty_value
from ..device import resolve_device, synchronize
from .config import SolverConfig
from .report import FitReport

#: |entry| below this counts as a structural zero when observing density
NNZ_TOL = 1e-8

#: default block-density threshold for sparse_matmul="on"
DEFAULT_SPARSE_THRESHOLD = 0.25

#: relative asymmetry above this rejects an input covariance
SYMMETRY_RTOL = 1e-6


def _require_finite(name: str, arr: torch.Tensor) -> None:
    with host_sync("estimator/backends.py:_require_finite"):
        finite = bool(torch.isfinite(arr).all())
    if not finite:
        raise ValueError(
            f"{name} contains NaN/Inf; refusing to fit (a non-finite input "
            f"silently produces a garbage estimate — clean or impute the "
            f"data first)")


def _require_symmetric(s: torch.Tensor) -> None:
    if s.numel() == 0:
        return
    with host_sync("estimator/backends.py:_require_symmetric"):
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
    with host_sync("estimator/backends.py:observed_nnz_per_row"):
        nnz = int((om.abs() > NNZ_TOL).sum())
    return max(1.0, nnz / om.shape[0])


def _problem_shape(problem: Problem, lam1: float,
                   omega0=None) -> ProblemShape:
    """Cost-model shape; a warm start's OBSERVED density replaces the
    static prior."""
    if omega0 is not None:
        d = observed_nnz_per_row(omega0)
    else:
        d = estimate_density(problem.p, problem.n, lam1)
    return ProblemShape(p=problem.p, n=problem.n, d=d)


def _matmul_policy(config: SolverConfig, p: int, m: int,
                   device) -> matops.MatmulPolicy | None:
    """Resolve the config's sparse_matmul knobs into a routing policy for
    an Omega-side product with ``m`` output columns on ``device``.  On a
    CUDA device ``"auto"`` takes the crossover of the constants measured
    on the H100 (``CARD_BLOCK_MODEL``), elsewhere the data-sheet model's."""
    mode = config.sparse_matmul
    if mode == "off":
        return None
    if mode == "on":
        thr = (config.sparse_threshold if config.sparse_threshold is not None
               else DEFAULT_SPARSE_THRESHOLD)
    else:  # auto
        on_card = torch.device(device).type == "cuda"
        thr = crossover_density(p, m, config.sparse_block,
                                model=CARD_BLOCK_MODEL if on_card else None)
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
            c_omega: int = 1, n_devices: int = 1,
            telemetry: dict | None = None) -> FitReport:
    """The report of one solve.  The nnz and block-occupancy scan of the
    estimate runs on its device; only scalars come back.  The same count
    feeds the deferred obs registry feed (``_solve_with_obs``), so obs
    adds no second scan and no host copy of Omega."""
    om = res.omega
    p = om.shape[0]
    with span("fit.report", level="summary"):
        nz = om.abs() > NNZ_TOL
        bs = config.sparse_block
        occ = matops.block_mask(nz, bs)
        with host_sync("estimator/backends.py:_report"):
            nnz, n_occ = torch.stack([nz.sum(), (occ > 0).sum()]).tolist()
    nnz_per_row = max(1.0, nnz / p)
    if telemetry is not None and "_pending_cost" in telemetry:
        from ..obs.metrics import get_registry, record_solve_cost
        cost = record_solve_cost(get_registry(), density=nnz_per_row / p,
                                 **telemetry.pop("_pending_cost"))
        telemetry["flops"] = cost["flops"]
        telemetry["words"] = cost["words"]
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
        nnz_per_row=nnz_per_row,
        block_density=n_occ / occ.numel(),
        sparse_matmul=config.sparse_matmul,
        device=str(om.device),
        telemetry=telemetry,
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
        config, problem.p, problem.p if variant == "cov" else problem.n,
        data.device)
    res, wall, telemetry = _solve_with_obs(
        config, "reference", variant, lambda: prox.solve_reference(
            data, penalty=spec, omega0=omega0, variant=variant,
            tol=config.tol, max_iters=config.max_iters,
            max_ls=config.max_ls, warm_start_tau=config.warm_start_tau,
            tau_schedule=config.tau_schedule, sparse_matmul=policy,
            use_kernels=config.use_pallas),
        data.device, p=problem.p, n=problem.n)
    return _report(res, lam1=lam1, lam2=float(spec.lam2), wall=wall,
                   backend="reference", variant=variant, config=config,
                   penalty=spec, telemetry=telemetry)


def obs_scope(mode: str):
    """The obs tracer at ``mode`` (``SolverConfig.obs``) for a call's
    duration; at ``"off"`` nothing, and ``repro_torch.obs`` stays
    unimported."""
    if mode == "off":
        return contextlib.nullcontext()
    from ..obs.trace import get_tracer
    return get_tracer().scoped(mode)


def _solve_with_obs(config: SolverConfig, backend: str, variant: str,
                    solve, device: torch.device, *, p: int, n: int,
                    n_devices: int = 1, c_x: int = 1, c_omega: int = 1):
    """``solve()`` under the configured observability level: (result,
    host wall ending in a device sync, telemetry or None).

    ``obs="off"`` is the plain timed solve and never imports
    ``repro_torch.obs`` (its spans are then profiler ranges under a
    recording profiler, else no-ops).  Otherwise the solve runs inside a
    ``fit.<backend>`` span; at ``"trace"`` it is split into ``dispatch``
    and ``execute`` spans.  Here (the reference's split is trace +
    compile + enqueue against ``block_until_ready``) "dispatch" is the
    host-side solve loop, which issues every launch and reads the
    scalars that steer it, and "execute" is ``torch.cuda.synchronize``:
    the device's drain of whatever the loop left queued (on the CPU,
    nothing).  The solve metrics feed the process registry and the
    telemetry dict lands on the report.  No level adds a launch or reads
    a device value inside the solve, so the estimate, the counts and the
    kernel launches are the same at every level."""
    if device.type == "cuda":
        # a float32 solve keeps full float32 products (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
    synchronize(device)
    with obs_scope(config.obs):
        t0 = time.perf_counter()
        with span(f"fit.{backend}", level="summary", variant=variant, p=p,
                  n=n, n_devices=n_devices) as fit_span:
            with span("dispatch", variant=variant):
                res = solve()
            t1 = time.perf_counter()
            with span("execute", variant=variant):
                synchronize(device)
        wall = time.perf_counter() - t0
        if config.obs == "off":
            return res, wall, None
        iters, ls_total = int(res.iters), int(res.ls_total)
        fit_span.note(iters=iters, ls_total=ls_total,
                      converged=bool(res.converged))
        telemetry = {
            "obs": config.obs,
            "dispatch_s": t1 - t0,
            "execute_s": wall - (t1 - t0),
            "ls_per_iter": ls_total / max(iters, 1),
            # the registry feed needs the OBSERVED density, which
            # _report's device-side nnz scan counts anyway: it is fed
            # there, from that count
            "_pending_cost": dict(
                variant=variant, p=p, n=n, iters=iters, ls_total=ls_total,
                n_devices=n_devices, c_x=c_x, c_omega=c_omega,
                wall_s=wall),
        }
    return res, wall, telemetry


def distributed_backend(problem: Problem, penalty, config: SolverConfig,
                        omega0=None) -> FitReport:
    """1.5D solve over the process group's ranks (``config.n_devices``,
    by default the world size), called on every rank; each rank gets the
    whole estimate.  At ``obs="trace"`` on the dense path, the comm
    watcher reconciles the collectives this rank posted against the
    analytic prediction (``telemetry["comm_reconcile"]``)."""
    spec = as_penalty(penalty)
    lam1 = float(spec.lam1)
    n_dev = config.n_devices or world_size()
    variant, c_x, c_omega = _resolve_variant(problem, lam1, config, n_dev,
                                             omega0)
    grid = Grid1p5D(n_dev, c_x, c_omega)
    if variant != "cov" and problem.x is None:
        raise ValueError("Obs variant requires the data matrix x")
    data = _cast(problem.cov() if variant == "cov" else problem.x, config)
    policy = _matmul_policy(
        config, problem.p, problem.p if variant == "cov" else problem.n,
        data.device)
    fit = dist.fit_cov if variant == "cov" else dist.fit_obs
    # the sparse policy's mask traffic has no analytic twin: only the
    # dense dispatch is reconciled
    watch = None
    if config.obs == "trace" and policy is None:
        from ..obs.commwatch import CommWatch
        watch = CommWatch().install()
    try:
        res, wall, telemetry = _solve_with_obs(
            config, "distributed", variant, lambda: fit(
                data, penalty=spec, grid=grid, tol=config.tol,
                max_iters=config.max_iters, max_ls=config.max_ls,
                warm_start_tau=config.warm_start_tau,
                use_pallas=config.use_pallas, omega0=omega0,
                sparse_matmul=policy),
            data.device, p=problem.p, n=problem.n, n_devices=n_dev,
            c_x=grid.c_x, c_omega=grid.c_omega)
    finally:
        if watch is not None:
            watch.uninstall()
    if watch is not None:
        recon = watch.reconcile()
        telemetry["comm_reconcile"] = [r.to_json() for r in recon]
        telemetry["comm_reconcile_ok"] = all(r.ok for r in recon)
    return _report(res, lam1=lam1, lam2=float(spec.lam2), wall=wall,
                   backend="distributed", variant=res.variant,
                   config=config, penalty=spec, c_x=grid.c_x,
                   c_omega=grid.c_omega, n_devices=n_dev,
                   telemetry=telemetry)


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
