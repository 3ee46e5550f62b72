"""``ConcordEstimator`` — the sklearn-style front door, in torch.

Port of ``repro.estimator.estimator``:

    est = ConcordEstimator(penalty=PenaltySpec.l1(0.3, 0.05),
                           config=SolverConfig(backend="reference"))
    est.fit(X)                      # (n, p) observations
    est.fit_cov(S, n_samples=n)     # (p, p) sample covariance
    path = est.fit_path(X, lam1_grid=[...])        # warm-started path
    best = path.best_bic()                         # model selection

Inputs may be numpy arrays or tensors; they move to ``config.device``
(the CUDA card unless ``device="cpu"``).  Streaming ``fit`` and
``transform=`` (data slice), ``fit_gram`` (data slice), ``fit_batch`` and
``fit_path(mode="batched"|"auto")`` (batched-engine slice) and
``fit_path(adaptive=True)`` raise ``NotImplementedError`` naming the
slice that brings them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable

from ..core.penalty import PenaltySpec, as_penalty
from .backends import Problem, get_backend
from .config import SolverConfig
from .report import FitReport, PathResult, pseudo_bic

_DATA_SLICE = "the data slice (ROADMAP A6)"
_BATCH_SLICE = "the batched-engine slice (ROADMAP A7)"


def _later(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} arrives with {where} of the "
                               f"PyTorch port")


def _is_matrix(x) -> bool:
    """An in-memory (n, p) matrix, as opposed to a chunk stream."""
    return isinstance(x, (list, tuple)) or hasattr(x, "__array__")


def _validate_grid(lam1_grid) -> list[float]:
    try:
        grid = [float(v) for v in lam1_grid]
    except TypeError:
        raise ValueError(f"lam1_grid must be an iterable of floats, got "
                         f"{lam1_grid!r}") from None
    if not grid:
        raise ValueError("lam1_grid must be non-empty")
    for v in grid:
        if not math.isfinite(v) or v <= 0:
            raise ValueError(f"lam1_grid values must be finite and > 0, "
                             f"got {v}")
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

    def fit(self, x, *, omega0=None, transform: str | None = None,
            chunk_rows: int | None = None) -> "ConcordEstimator":
        """Fit from an in-memory (n, p) observation matrix."""
        if transform is not None or chunk_rows is not None \
                or not _is_matrix(x):
            raise _later("fit from a chunk stream or with transform=",
                         _DATA_SLICE)
        problem = self._problem(x=x)
        return self._finish(self._solve(problem, self.penalty, omega0))

    def fit_cov(self, s, *, n_samples: int | None = None,
                omega0=None) -> "ConcordEstimator":
        """Fit from a (p, p) sample covariance (forces the Cov variant)."""
        problem = self._problem(s=s, n_samples=n_samples)
        return self._finish(self._solve(problem, self.penalty, omega0))

    def fit_gram(self, gram, *, omega0=None) -> "ConcordEstimator":
        raise _later("fit_gram", _DATA_SLICE)

    def fit_batch(self, *args, **kwargs):
        raise _later("fit_batch", _BATCH_SLICE)

    # -- regularization path --------------------------------------------

    def fit_path(self, x=None, lam1_grid: Iterable[float] = (), *,
                 s=None, n_samples: int | None = None,
                 warm_start: bool = True,
                 score_bic: bool = True,
                 mode: str = "sequential",
                 adaptive: bool = False,
                 adaptive_eps: float = 1e-3) -> PathResult:
        """Fit a descending lam1 path, each point warm-started from the
        previous solution (``warm_start``), with a pseudo-likelihood BIC
        per point (``score_bic``) for ``PathResult.best_bic()``."""
        if mode not in ("sequential", "batched", "auto"):
            raise ValueError(f"mode must be 'sequential', 'batched' or "
                             f"'auto', got {mode!r}")
        if mode != "sequential":
            raise _later(f"fit_path(mode={mode!r})", _BATCH_SLICE)
        if adaptive:
            raise _later("fit_path(adaptive=True)", _BATCH_SLICE)
        grid = _validate_grid(lam1_grid)
        if score_bic and x is None and n_samples is None:
            raise ValueError(
                "BIC scoring needs the sample count: pass n_samples "
                "alongside s, or score_bic=False")
        problem = self._problem(x=x, s=s, n_samples=n_samples)
        # form the covariance once for the whole path
        if problem.s is None and (score_bic or self.config.variant != "obs"):
            problem = problem._replace(s=problem.cov())
        grid = sorted(grid, reverse=True)
        reports, omega0 = [], None
        for lam1 in grid:
            rep = self._solve(problem, self.penalty.with_lam1(lam1),
                              omega0 if warm_start else None)
            if score_bic:
                rep = dataclasses.replace(
                    rep, bic=pseudo_bic(rep.omega, problem.s, problem.n))
            reports.append(rep)
            omega0 = rep.omega
        self._finish(reports[-1])
        return PathResult(reports=tuple(reports), warm_start=warm_start)


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
        n_samples: int | None = None,
        config: SolverConfig | None = None, **knobs) -> FitReport:
    """One-call fit.  Extra keyword args are SolverConfig fields (e.g.
    ``backend="reference"``, ``device="cpu"``)."""
    est = _estimator(penalty, lam1, lam2, config, knobs)
    if x is not None:
        est.fit(x)
    else:
        est.fit_cov(s, n_samples=n_samples)
    return est.report_


def fit_path(x=None, lam1_grid: Iterable[float] = (), *, s=None,
             lam2: float = 0.0,
             penalty: PenaltySpec | str | None = None,
             n_samples: int | None = None,
             warm_start: bool = True, score_bic: bool = True,
             config: SolverConfig | None = None, **knobs) -> PathResult:
    """One-call warm-started regularization path."""
    est = _estimator(penalty, 1.0, lam2, config, knobs)
    return est.fit_path(x, lam1_grid, s=s, n_samples=n_samples,
                        warm_start=warm_start, score_bic=score_bic)
