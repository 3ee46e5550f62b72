"""``ConcordEstimator`` — the sklearn-style front door, in torch.

Port of ``repro.estimator.estimator``:

    est = ConcordEstimator(penalty=PenaltySpec.l1(0.3, 0.05),
                           config=SolverConfig(backend="reference"))
    est.fit(X)                      # (n, p) observations — or ANY chunk
                                    # stream (generator, shard paths, ...)
    est.fit_cov(S, n_samples=n)     # (p, p) sample covariance
    est.fit_gram(gram_result)       # streamed Gram from repro_torch.data
    path = est.fit_path(X, lam1_grid=[...])        # warm-started path
    path = est.fit_path(X, lam1_grid=[...], mode="batched")  # in lock step
    best = path.best_bic()                         # model selection
    grid = est.fit_grid(X, lam1_grid=[...], lam2_grid=[...])  # per lam2
    best = grid.best_bic()                         # over every point
    est.fit_batch(s=S_stack, lam1=[...])           # B stacked problems

Inputs may be numpy arrays or tensors; they move to ``config.device``
(the CUDA card unless ``device="cpu"``).  Chunk streams, and arrays with
``transform=`` set, are reduced to their float64 Gram on that device by
``data.compute_gram`` and solved through the Cov variant.

``fit_path(mode="auto")`` prices the batched and sequential modes with
the step cost of the device the path runs on: the reference's CPU-host
ratios on the CPU, the H100's measured ratios on a CUDA device, where a
sequential trial through the block-sparse kernel is several times
cheaper than a dense batched lane trial (``_resolve_path_mode``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import numpy as np

from ..census import span
from ..core.costmodel import CARD_STEP_COST, choose_path_mode
from ..core.penalty import PenaltySpec, adaptive_weights, as_penalty
from ..core.prox import resolve_tau_schedule
from ..data.gram import compute_gram
from ..data.shards import is_streaming_input
from ..device import resolve_device
from .backends import Problem, _matmul_policy, get_backend, obs_scope
from .batch import batched_path_reports, fit_batch as _fit_batch
from .config import SolverConfig
from .report import FitReport, GridResult, PathResult, pseudo_bic

def _validate_grid(values, name: str = "lam1_grid", *,
                   positive: bool = True, unique: bool = False) -> list[float]:
    try:
        grid = [float(v) for v in values]
    except TypeError:
        raise ValueError(f"{name} must be an iterable of floats, got "
                         f"{values!r}") from None
    if not grid:
        raise ValueError(f"{name} must be non-empty")
    for v in grid:
        if not math.isfinite(v) or v < 0 or (positive and v == 0):
            raise ValueError(f"{name} values must be finite and "
                             f"{'>' if positive else '>='} 0, got {v}")
    if unique and len(set(grid)) != len(grid):
        raise ValueError(f"{name} repeats a value: {grid}")
    return grid


class ConcordEstimator:
    """Sparse inverse covariance estimation via CONCORD.

    After ``fit``/``fit_cov`` the instance exposes ``omega_`` (a tensor on
    the solve's device), ``report_`` (a :class:`FitReport`) and
    ``n_iter_``.  ``penalty`` accepts a :class:`PenaltySpec`, a string
    form (strength from ``lam1``/``lam2``), or None (``config.penalty``).
    """

    def __init__(self, lam1: float | None = None, lam2: float | None = None,
                 penalty: PenaltySpec | str | None = None,
                 config: SolverConfig | None = None):
        self.config = config or SolverConfig()
        if not isinstance(self.config, SolverConfig):
            raise TypeError(f"config must be a SolverConfig, got "
                            f"{type(self.config).__name__}")
        if isinstance(penalty, PenaltySpec):
            if lam1 is not None or lam2 is not None:
                raise ValueError(
                    "a PenaltySpec already carries lam1/lam2; pass either "
                    "the spec or the scalar kwargs, not both")
            spec = penalty
        else:
            spec = as_penalty(penalty if penalty is not None
                              else self.config.penalty,
                              lam1=0.1 if lam1 is None else lam1,
                              lam2=lam2)
        self.penalty: PenaltySpec = spec
        self.omega_ = None
        self.report_: FitReport | None = None
        self.n_iter_: int | None = None

    @property
    def lam1(self) -> float:
        return float(self.penalty.lam1)

    @lam1.setter
    def lam1(self, value) -> None:
        self.penalty = self.penalty.with_lam1(float(value))

    @property
    def lam2(self) -> float:
        return float(self.penalty.lam2)

    @lam2.setter
    def lam2(self, value) -> None:
        self.penalty = dataclasses.replace(self.penalty, lam2=float(value))

    # -- single fits ----------------------------------------------------

    def _problem(self, **kw) -> Problem:
        return Problem.from_data(device=self.config.device, **kw)

    def _solve(self, problem: Problem, spec: PenaltySpec,
               omega0=None) -> FitReport:
        backend = get_backend(self.config.backend)
        return backend(problem, spec, self.config, omega0)

    def _finish(self, report: FitReport) -> "ConcordEstimator":
        self.report_ = report
        self.omega_ = report.omega
        self.n_iter_ = report.iters
        return self

    def _gram(self, x, transform, chunk_rows):
        return compute_gram(x, transform=transform or "none",
                            chunk_rows=chunk_rows, device=self.config.device)

    def fit(self, x, *, omega0=None, transform: str | None = None,
            chunk_rows: int | None = None) -> "ConcordEstimator":
        """Fit from observations (either variant works).

        ``x`` may be an in-memory (n, p) matrix, OR any chunk stream the
        data subsystem understands — a generator/iterator of row-blocks,
        a ``ChunkSource``, shard file paths, or a zero-arg factory (see
        ``repro_torch.data.shards``).  Streams (and arrays with
        ``transform`` set) are reduced to their f64 Gram on the solve's
        device by ``data.compute_gram`` without materializing X, then
        solved through the Cov variant."""
        if is_streaming_input(x) or transform is not None:
            return self.fit_gram(self._gram(x, transform, chunk_rows),
                                 omega0=omega0)
        problem = self._problem(x=x)
        return self._finish(self._solve(problem, self.penalty, omega0))

    def fit_cov(self, s, *, n_samples: int | None = None,
                omega0=None) -> "ConcordEstimator":
        """Fit from a (p, p) sample covariance (forces the Cov variant)."""
        problem = self._problem(s=s, n_samples=n_samples)
        return self._finish(self._solve(problem, self.penalty, omega0))

    def fit_gram(self, gram, *, omega0=None) -> "ConcordEstimator":
        """Fit from a streamed Gram (``data.compute_gram`` or a
        ``launch.gram prep`` artifact through ``launch.gram.load_gram``).

        Accepts a :class:`repro_torch.data.GramResult` or anything
        exposing ``.s`` (the (p, p) Gram) and ``.n`` (rows streamed); a
        tensor already on the solve's device is used where it is.
        Validation (symmetry, finiteness) applies as in ``fit_cov``."""
        s = getattr(gram, "s", None)
        n = getattr(gram, "n", None)
        if s is None or n is None:
            raise TypeError(
                f"fit_gram wants a GramResult-like object with .s and .n "
                f"(got {type(gram).__name__}); for a plain covariance "
                f"array use fit_cov(s, n_samples=...)")
        problem = self._problem(s=s, n_samples=int(n))
        return self._finish(self._solve(problem, self.penalty, omega0))

    # -- regularization path --------------------------------------------

    def _resolve_path_mode(self, mode: str, grid: list[float],
                           problem: Problem) -> str:
        """``fit_path(mode="auto")``: the cost model's batched-vs-
        sequential predictor with the engine knobs this config would run
        (tau schedule, chunk, pilot warm start) and the step cost of the
        device it runs on.

        The rule: on the CPU a batched lane step costs what the batch
        layer's product route costs on the reference's host
        (``GEMM_STEP_COST``: ``"host"`` for ``batch_gemm="auto"``).  On a
        CUDA device it costs what the H100 measured
        (``CARD_STEP_COST``), by the route a SEQUENTIAL trial takes: with
        a block-sparse policy (``sparse_matmul`` on, or auto with a
        positive crossover) the sequential product is kernel 2 while
        the batched engine stays dense, so a batched lane trial costs
        several sequential trials ("blocksparse"); without one both are
        dense ("dense")."""
        if mode != "auto":
            return mode
        gemm = self.config.batch_gemm
        dev = resolve_device(self.config.device)
        if gemm == "auto":
            # the batch layer's resolution, to the step-cost class
            gemm = "host" if dev.type == "cpu" else "xla"
        step_cost = None
        if dev.type == "cuda":
            m = problem.n if self.config.variant == "obs" else problem.p
            sparse = _matmul_policy(self.config, problem.p, m,
                                    dev) is not None
            step_cost = CARD_STEP_COST["blocksparse" if sparse else "dense"]
        return choose_path_mode(
            grid,
            tau_schedule=resolve_tau_schedule(
                self.config.tau_schedule, self.config.warm_start_tau),
            chunk=self.config.batch_chunk,
            max_iters=self.config.max_iters,
            gemm=gemm, warm_start=self.config.batch_warm_start,
            step_cost=step_cost)

    def _run_path(self, problem: Problem, grid: list[float],
                  spec: PenaltySpec, mode: str, warm_start: bool,
                  score_bic: bool):
        with obs_scope(self.config.obs):
            with span("fit_path", level="summary", points=len(grid),
                      mode=mode) as path_span:
                reports, stats = self._run_path_inner(
                    problem, grid, spec, mode, warm_start, score_bic)
                path_span.note(total_iters=sum(r.iters for r in reports))
        return reports, stats

    def _run_path_inner(self, problem: Problem, grid: list[float],
                        spec: PenaltySpec, mode: str, warm_start: bool,
                        score_bic: bool):
        stats = None
        if mode == "batched":
            reports, _, stats = batched_path_reports(
                problem, grid, self.config, penalty=spec)
        else:
            reports, omega0 = [], None
            for lam1 in grid:
                rep = self._solve(problem, spec.with_lam1(lam1),
                                  omega0 if warm_start else None)
                reports.append(rep)
                omega0 = rep.omega
        if score_bic:
            reports = self._score(reports, problem)
        return reports, stats

    def _score(self, reports, problem: Problem) -> list:
        """Each report with its BIC.  Its product goes through the policy
        the solve of this problem resolves at the product's width: Omega S
        (m = p) on Cov, Omega X^T (m = n) on an Obs problem, which holds
        no S and never forms one."""
        obs = problem.s is None
        m = problem.n if obs else problem.p
        return [dataclasses.replace(
            rep, bic=pseudo_bic(
                rep.omega, problem.s, problem.n,
                x=problem.x if obs else None,
                policy=_matmul_policy(self.config, problem.p, m,
                                      rep.omega.device)))
            for rep in reports]

    def _path_problem(self, x, s, n_samples, score_bic: bool,
                      transform=None, chunk_rows=None) -> Problem:
        """The problem a path or a grid solves: a chunk stream (or an
        array with ``transform`` set) reduced to its Gram first; a Cov
        (or auto) problem given x forms its covariance once here, an Obs
        problem never does."""
        if x is not None and (is_streaming_input(x)
                              or transform is not None):
            gram = self._gram(x, transform, chunk_rows)
            x, s, n_samples = None, gram.s, gram.n
        if score_bic and x is None and n_samples is None:
            raise ValueError(
                "BIC scoring needs the sample count: pass n_samples "
                "alongside s, or score_bic=False")
        problem = self._problem(x=x, s=s, n_samples=n_samples)
        if problem.s is None and self.config.variant != "obs":
            problem = problem._replace(s=problem.cov())
        return problem

    def fit_path(self, x=None, lam1_grid: Iterable[float] = (), *,
                 s=None, n_samples: int | None = None,
                 warm_start: bool = True,
                 score_bic: bool = True,
                 mode: str = "sequential",
                 adaptive: bool = False,
                 adaptive_eps: float = 1e-3,
                 transform: str | None = None,
                 chunk_rows: int | None = None) -> PathResult:
        """Fit a descending lam1 path with a pseudo-likelihood BIC per
        point (``score_bic``) for ``PathResult.best_bic()``.  An Obs
        problem never forms S: its BIC takes Omega X^T.

        ``x`` may be a chunk stream, as in ``fit``: it (or an array with
        ``transform`` set) is reduced to its Gram first, which then
        stands for ``s`` and its row count for ``n_samples``.

        ``mode="sequential"`` solves point by point, each warm-started
        from the previous solution (``warm_start``).  ``mode="batched"``
        runs the whole grid in lock step (``core.batch``): every point
        starts cold, and each equals its cold sequential solve.
        ``mode="auto"`` asks the cost model (``choose_path_mode``).

        ``adaptive=True`` runs the two-stage adaptive lasso: stage 1 is a
        plain l1 path over the grid, then each point is refit with
        ``weighted_l1`` weights ``1 / (|omega_hat| + adaptive_eps)`` from
        stage 1's estimate at the same lam1.  In batched mode the
        per-point weights ride as one (B, p, p) lane leaf.  Returns the
        stage-2 path with ``adaptive=True`` and ``stage1`` attached."""
        if mode not in ("sequential", "batched", "auto"):
            raise ValueError(f"mode must be 'sequential', 'batched' or "
                             f"'auto', got {mode!r}")
        grid = _validate_grid(lam1_grid)
        problem = self._path_problem(x, s, n_samples, score_bic, transform,
                                     chunk_rows)
        mode = self._resolve_path_mode(mode, grid, problem)
        grid = sorted(grid, reverse=True)
        warm = warm_start and mode == "sequential"
        spec1 = self.penalty
        if adaptive and spec1.kind != "l1":
            # stage 1 of the adaptive refit is always a plain l1 path
            spec1 = PenaltySpec("l1", self.lam1, self.lam2)
        reports, bstats = self._run_path(problem, grid, spec1, mode,
                                         warm_start, score_bic)
        stage1 = PathResult(reports=tuple(reports), warm_start=warm,
                            mode=mode, batch_stats=bstats)
        if not adaptive:
            self._finish(reports[-1])
            return stage1
        weights = [adaptive_weights(rep.omega, eps=adaptive_eps)
                   for rep in stage1.reports]
        bstats2 = None
        if mode == "batched":
            spec2 = PenaltySpec("weighted_l1", grid[0], self.lam2,
                                weights=np.stack(weights))
            reports2, _, bstats2 = batched_path_reports(
                problem, grid, self.config, penalty=spec2)
        else:
            reports2, omega0 = [], None
            for lam1, w in zip(grid, weights):
                spec2 = PenaltySpec("weighted_l1", lam1, self.lam2,
                                    weights=w)
                rep = self._solve(problem, spec2,
                                  omega0 if warm_start else None)
                reports2.append(rep)
                omega0 = rep.omega
        if score_bic:
            reports2 = self._score(reports2, problem)
        result = PathResult(reports=tuple(reports2), warm_start=warm,
                            mode=mode, adaptive=True, stage1=stage1,
                            batch_stats=bstats2)
        self._finish(reports2[-1])
        return result

    def fit_grid(self, x=None, lam1_grid: Iterable[float] = (),
                 lam2_grid: Iterable[float] = (), *, s=None,
                 n_samples: int | None = None,
                 score_bic: bool = True) -> GridResult:
        """Fit a (lam1, lam2) grid, as the paper's Section 5 selects a
        subject's model: one sequential path over the descending lam1
        grid per lam2, each warm within itself and each starting from
        the identity, with a pseudo-likelihood BIC per point
        (``score_bic``) for ``GridResult.best_bic()``.

        The data are validated, and a Cov problem's covariance formed,
        once for the whole grid; an Obs problem never forms S, its BIC
        included.  The last point solved lands on ``report_`` /
        ``omega_``, as after ``fit_path``."""
        grid = sorted(_validate_grid(lam1_grid), reverse=True)
        lam2s = _validate_grid(lam2_grid, "lam2_grid", positive=False,
                               unique=True)
        problem = self._path_problem(x, s, n_samples, score_bic)
        paths = {}
        with obs_scope(self.config.obs), span(
                "fit_grid", level="summary", points=len(grid) * len(lam2s),
                lam2s=len(lam2s)):
            for lam2 in lam2s:
                spec = dataclasses.replace(self.penalty, lam2=lam2)
                reports, _ = self._run_path(problem, grid, spec,
                                            "sequential", True, score_bic)
                paths[lam2] = PathResult(reports=tuple(reports))
        self._finish(reports[-1])
        return GridResult(paths=paths)

    # -- batched multi-problem solves -----------------------------------

    def fit_batch(self, x=None, *, s=None, lam1=None, lam2=None,
                  penalty=None, omega0=None):
        """Solve stacked (B, ...) problems in lock step.

        ``x``: (B, n, p) stacked observation matrices or ``s``: (B, p, p)
        stacked covariances.  The batch runs the estimator's penalty
        family; ``lam1``/``lam2`` override only the strengths (scalars or
        length-B sequences).  ``penalty`` replaces the spec outright: a
        string form (strength from lam1/lam2, defaulting to the
        estimator's) or a spec whose numeric leaves may carry a (B,) lane
        axis.  Returns a :class:`BatchReport`; the last problem's report
        also lands on ``report_``/``omega_``."""
        if penalty is None:
            spec = self.penalty
            if lam1 is not None:
                spec = spec.with_lam1(np.asarray(lam1, np.float64))
            if lam2 is not None:
                spec = dataclasses.replace(
                    spec, lam2=np.asarray(lam2, np.float64))
        elif isinstance(penalty, str):
            spec = as_penalty(penalty,
                              lam1=self.lam1 if lam1 is None else lam1,
                              lam2=self.lam2 if lam2 is None else lam2)
        else:
            if lam1 is not None or lam2 is not None:
                raise ValueError(
                    "a PenaltySpec already carries lam1/lam2; pass either "
                    "the spec or the scalar overrides, not both")
            spec = as_penalty(penalty)
        result = _fit_batch(x, s=s, penalty=spec, omega0=omega0,
                            config=self.config)
        self._finish(result.reports[-1])
        return result


# ---------------------------------------------------------------------------
# functional facade
# ---------------------------------------------------------------------------

def _estimator(penalty, lam1, lam2, config, knobs) -> ConcordEstimator:
    cfg = (config or SolverConfig()).replace(**knobs) if knobs else \
        (config or SolverConfig())
    if isinstance(penalty, PenaltySpec):
        return ConcordEstimator(penalty=penalty, config=cfg)
    return ConcordEstimator(lam1=lam1, lam2=lam2, penalty=penalty,
                            config=cfg)


def fit(x=None, *, s=None, lam1: float | None = None, lam2: float = 0.0,
        penalty: PenaltySpec | str | None = None,
        n_samples: int | None = None, transform: str | None = None,
        chunk_rows: int | None = None,
        config: SolverConfig | None = None, **knobs) -> FitReport:
    """One-call fit.  ``x`` may be a matrix or a chunk stream
    (``transform``/``chunk_rows`` ride through to the streaming Gram
    pipeline).  Extra keyword args are SolverConfig fields (e.g.
    ``backend="reference"``, ``device="cpu"``)."""
    est = _estimator(penalty, lam1, lam2, config, knobs)
    if x is not None:
        est.fit(x, transform=transform, chunk_rows=chunk_rows)
    else:
        est.fit_cov(s, n_samples=n_samples)
    return est.report_


def fit_path(x=None, lam1_grid: Iterable[float] = (), *, s=None,
             lam2: float = 0.0,
             penalty: PenaltySpec | str | None = None,
             n_samples: int | None = None,
             warm_start: bool = True, score_bic: bool = True,
             mode: str = "sequential", adaptive: bool = False,
             transform: str | None = None, chunk_rows: int | None = None,
             config: SolverConfig | None = None, **knobs) -> PathResult:
    """One-call regularization path (sequential warm-started,
    ``mode="batched"`` in lock step, or ``adaptive=True`` for the
    two-stage adaptive lasso); ``x`` may be a chunk stream, as in
    :func:`fit`."""
    est = _estimator(penalty, 1.0, lam2, config, knobs)
    return est.fit_path(x, lam1_grid, s=s, n_samples=n_samples,
                        warm_start=warm_start, score_bic=score_bic,
                        mode=mode, adaptive=adaptive, transform=transform,
                        chunk_rows=chunk_rows)

