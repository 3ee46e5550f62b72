"""Batched estimator surface: ``fit_batch`` and the batched lam1-path engine.

Port of ``repro.estimator.batch``, a thin facade over
:mod:`repro_torch.core.batch`:

  * ``fit_batch`` — solve B stacked independent problems in lock step;
    returns a :class:`BatchReport` of per-problem :class:`FitReport`s.
    ``penalty`` accepts a :class:`PenaltySpec` whose numeric leaves may
    be (B,)-batched, so different lanes run different parameters.
  * ``batched_path_reports`` — the engine behind
    ``ConcordEstimator.fit_path(mode="batched")``: a whole lam1 grid
    against shared data.

The engine runs the single-device reference loop with dense products;
the distributed drivers stay per-problem backends.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..census import CENSUS, host_sync, span
from ..core import batch as core_batch
from ..core.penalty import PenaltySpec, _as_numpy, normalize_penalty
from ..core.prox import ProxResult
from ..device import resolve_device, synchronize
from .backends import Problem, _cast, _report, obs_scope
from .config import SolverConfig
from .report import BatchReport, FitReport


def _check_engine(config: SolverConfig) -> None:
    if config.backend == "distributed":
        raise ValueError(
            "the batched engine runs the single-device reference loop; "
            "use backend='reference' or 'auto' (distributed solves stay "
            "per-problem)")


def _resolve_batch_variant(config: SolverConfig, have_s: bool) -> str:
    """The batched engine's variant="auto" rule: Cov when a covariance is
    already available, Obs for raw stacked datasets."""
    if config.variant != "auto":
        return config.variant
    return "cov" if have_s else "obs"


def _resolve_batch_gemm(config: SolverConfig, variant: str,
                        data: torch.Tensor) -> str:
    """``batch_gemm="auto"``: the host product exactly where the
    reference takes it — a CPU solve, Cov variant, compact schedule,
    kernels off, float64 — else the product on the solve's device."""
    if config.batch_gemm != "auto":
        return config.batch_gemm
    if (variant == "cov" and config.batch_schedule == "compact"
            and not config.use_pallas and data.dtype == torch.float64
            and data.device.type == "cpu"):
        return "host"
    return "xla"


def _slice_result(res: ProxResult, i: int) -> ProxResult:
    """Lane ``i`` of a batched result, in the per-solve form (the
    iterate a tensor, the rest Python scalars)."""
    vals = {f.name: getattr(res, f.name)[i]
            for f in dataclasses.fields(ProxResult)}
    # report assembly after the solve: a few scalars of one lane
    with host_sync("estimator/batch.py:_slice_result", reads=len(vals) - 1):
        return ProxResult(**{k: v if k == "omega" else v.item()  # ca: allow=CA106
                             for k, v in vals.items()})


def _flat_steps() -> int:
    """Flat steps the batched engine has run since the census's reset."""
    return CENSUS.spans.get("batch.flat_step", 0)


def batch_reports(res: ProxResult, lam1s, lam2s, wall: float, *,
                  variant: str, config: SolverConfig,
                  backend: str = "batched",
                  penalty: PenaltySpec | None = None) -> list[FitReport]:
    """Split one batched result into per-problem FitReports.

    ``penalty`` is the (possibly lane-batched) spec the batch ran with;
    each report gets its own lane (``PenaltySpec.lane``).  Each report
    carries a 1/B share of the batch's wall time."""
    b = len(lam1s)
    # the engine always runs dense products: report the routing that ran
    config = config.replace(sparse_matmul="off")
    lanes = [PenaltySpec("l1", float(lam1s[i]), float(lam2s[i]))
             for i in range(b)]
    if penalty is not None:
        lanes = [penalty.lane(i, b).with_lam1(float(lam1s[i]))
                 for i in range(b)]
    return [
        _report(_slice_result(res, i), lam1=float(lam1s[i]),
                lam2=float(lam2s[i]), wall=wall / b, backend=backend,
                variant=variant, config=config, penalty=lanes[i])
        for i in range(b)
    ]


def fit_batch(x=None, *, s=None, lam1=None, lam2=0.0, penalty=None,
              omega0=None, config: SolverConfig | None = None,
              **knobs) -> BatchReport:
    """Solve B stacked problems in lock step on ``config.device``.

    ``x``: (B, n, p) stacked observation matrices, or ``s``: (B, p, p)
    stacked covariances.  ``lam1``/``lam2`` are scalars or length-B
    sequences; ``penalty`` instead passes a full spec (or string form)
    whose numeric leaves may carry a leading (B,) lane axis.  ``omega0``
    is None, one (p, p) warm start, or stacked (B, p, p).  Extra keyword
    args are ``SolverConfig`` fields.  Returns a :class:`BatchReport`.
    """
    cfg = (config or SolverConfig()).replace(**knobs) if knobs else \
        (config or SolverConfig())
    _check_engine(cfg)
    if (x is None) == (s is None):
        raise ValueError("pass exactly one of x (B, n, p) or s (B, p, p)")
    data = torch.as_tensor(x if x is not None else s,
                           device=resolve_device(cfg.device))
    if data.ndim != 3:
        raise ValueError(f"batched data must be 3-D stacked problems, got "
                         f"shape {tuple(data.shape)}")
    if s is not None and data.shape[-1] != data.shape[-2]:
        raise ValueError(f"s must stack square matrices, got "
                         f"{tuple(data.shape)}")
    variant = _resolve_batch_variant(cfg, have_s=s is not None)
    if variant == "obs" and x is None:
        raise ValueError("Obs variant requires the stacked data matrices x")
    if variant == "cov" and x is not None:
        # the per-problem covariances in one batched product
        data = torch.einsum("bni,bnj->bij", data, data) / data.shape[1]
    data = _cast(data, cfg)
    b = data.shape[0]
    kw = dict(omega0=omega0, variant=variant, tol=cfg.tol,
              max_iters=cfg.max_iters, max_ls=cfg.max_ls,
              warm_start_tau=cfg.warm_start_tau,
              tau_schedule=cfg.tau_schedule, schedule=cfg.batch_schedule,
              chunk=cfg.batch_chunk, max_lanes=cfg.batch_max_lanes,
              gemm=_resolve_batch_gemm(cfg, variant, data),
              return_stats=True)
    if penalty is not None:
        spec = normalize_penalty(penalty, lam1, lam2)
        lam1s = np.broadcast_to(np.asarray(_as_numpy(spec.lam1),
                                           np.float64), (b,))
        lam2s = np.broadcast_to(np.asarray(_as_numpy(spec.lam2),
                                           np.float64), (b,))
        kw["penalty"] = spec
    else:
        if lam1 is None:
            raise TypeError("pass lam1 (or penalty=)")
        spec = None
        lam1s = np.broadcast_to(np.asarray(lam1, np.float64), (b,))
        lam2s = np.broadcast_to(np.asarray(lam2, np.float64), (b,))
    with obs_scope(cfg.obs), span("fit_batch", level="summary",
                                  lanes=b) as batch_span:
        steps0 = _flat_steps()
        synchronize(data.device)
        t0 = time.perf_counter()
        if spec is None:
            res, stats = core_batch.solve_batch(
                data, torch.tensor(lam1s, dtype=data.dtype),
                torch.tensor(lam2s, dtype=data.dtype), **kw)
        else:
            res, stats = core_batch.solve_batch(data, **kw)
        synchronize(res.omega.device)
        wall = time.perf_counter() - t0
        batch_span.note(flat_steps=_flat_steps() - steps0,
                        segments=stats.segments)
        reports = batch_reports(res, lam1s, lam2s, wall, variant=variant,
                                config=cfg, penalty=spec)
    return BatchReport(reports=tuple(reports), wall_time_s=wall,
                       stats=stats)


def batched_path_reports(problem: Problem, grid: list[float],
                         config: SolverConfig, *,
                         penalty: PenaltySpec | None = None,
                         lam2: float = 0.0,
                         omega0=None):
    """Run a whole lam1 grid against shared data in lock step.

    ``penalty`` (optional) is the spec template whose lam1 the grid
    replaces.  The engine knobs (``batch_*``, ``tau_schedule``,
    ``use_pallas``) come from the config.  Returns (per-point reports in
    ``grid`` order, total wall seconds, the engine's
    :class:`~repro_torch.core.batch.BatchRunStats`).  Engine behind
    ``ConcordEstimator.fit_path(mode="batched")``."""
    _check_engine(config)
    variant = _resolve_batch_variant(config, have_s=problem.s is not None)
    if variant == "cov":
        data = _cast(problem.cov(), config)
    else:
        if problem.x is None:
            raise ValueError("Obs variant requires the data matrix x")
        data = _cast(problem.x, config)
    if omega0 is not None:
        omega0 = torch.as_tensor(omega0, dtype=data.dtype,
                                 device=data.device)
    if penalty is not None:
        lam2 = float(np.asarray(_as_numpy(penalty.lam2)))
    if data.device.type == "cuda":
        # a float32 solve keeps full float32 products (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
    with obs_scope(config.obs), span("fit_batch", level="summary",
                                     lanes=len(grid)) as batch_span:
        steps0 = _flat_steps()
        synchronize(data.device)
        t0 = time.perf_counter()
        res, stats = core_batch.solve_path_batched(
            data, np.asarray(grid, np.float64), lam2, penalty=penalty,
            omega0=omega0, variant=variant, tol=config.tol,
            max_iters=config.max_iters, max_ls=config.max_ls,
            warm_start_tau=config.warm_start_tau,
            tau_schedule=config.tau_schedule,
            schedule=config.batch_schedule, chunk=config.batch_chunk,
            max_lanes=config.batch_max_lanes, use_pallas=config.use_pallas,
            gemm=_resolve_batch_gemm(config, variant, data),
            warm_start=config.batch_warm_start, return_stats=True)
        synchronize(res.omega.device)
        wall = time.perf_counter() - t0
        batch_span.note(flat_steps=_flat_steps() - steps0,
                        segments=stats.segments)
        lam2s = [lam2] * len(grid)
        spec_b = penalty.with_lam1(np.asarray(grid, np.float64)) \
            if penalty is not None else None
        reports = batch_reports(res, grid, lam2s, wall, variant=variant,
                                config=config, penalty=spec_b)
    return reports, wall, stats
