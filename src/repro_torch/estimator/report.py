"""Fit results for the ``repro_torch.estimator`` facade.

Port of ``repro.estimator.report`` (``FitReport``, ``PathResult``,
``BatchReport``, ``pseudo_bic``), with ``GridResult`` for a (lam1, lam2)
grid and an Obs route for ``pseudo_bic`` that never forms S.
``FitReport.omega`` is the estimate as a torch tensor on the device the
solve ran on; every other field is a Python scalar.

``converged`` is True only on a genuine ``delta < tol`` exit; ``stalled``
is True when the line search exhausted ``max_ls`` trials without
accepting a step.  Both False means the iteration cap hit first.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..census import host_sync, span
from ..core import matops


@dataclass(frozen=True)
class FitReport:
    """Everything a caller may want to know about one solve."""
    omega: torch.Tensor         # (p, p) estimate on the solve's device
    lam1: float
    lam2: float
    iters: int                  # outer proximal-gradient iterations
    ls_total: int               # total line-search trials
    converged: bool
    objective: float            # full objective g + penalty value
    objective_smooth: float     # smooth part g (logdet + quad + ridge)
    wall_time_s: float
    backend: str                # backend that actually ran
    variant: str                # "cov" or "obs" as resolved
    c_x: int = 1
    c_omega: int = 1
    n_devices: int = 1
    bic: float | None = None    # filled in by fit_path for model selection
    nnz_per_row: float | None = None    # observed nnz/row of the estimate
    block_density: float | None = None  # occupied-block fraction at
                                        # sparse_block granularity
    sparse_matmul: str = "off"          # Omega-product routing mode
    stalled: bool = False
    penalty: str = "l1"
    device: str = "cpu"                 # device the solve ran on
    telemetry: dict | None = None       # obs != "off" only: the solve's
                                        # dispatch vs execute wall split,
                                        # analytic flop/word totals at
                                        # the observed shape, mean trials
                                        # per iteration; None at "off"

    def summary(self) -> str:
        dens = ""
        if self.block_density is not None:
            dens = (f" density={self.block_density:.3f}"
                    f"[{self.sparse_matmul}]")
        if self.nnz_per_row is not None:
            dens += f" nnz/row={self.nnz_per_row:.1f}"
        stall = " STALLED" if self.stalled else ""
        pen = f" pen={self.penalty}" if self.penalty != "l1" else ""
        return (f"[{self.backend}/{self.variant} {self.device}] "
                f"lam1={self.lam1:g}{pen} "
                f"iters={self.iters} ls={self.ls_total} "
                f"converged={self.converged}{stall} obj={self.objective:.4f}"
                f"{dens} t={self.wall_time_s:.3f}s")


#: the census's site of the BIC's one host read
_BIC_SITE = "estimator/report.py:pseudo_bic"


def pseudo_bic(omega, s, n: int, *, x=None, tol: float = 1e-8,
               policy: matops.MatmulPolicy | None = None) -> float:
    """BIC under the CONCORD pseudo-likelihood: ``2n * g0 + log(n) * |E|``
    with g0 the unpenalized smooth objective and |E| the edge count.

    Computed in float64 on ``omega``'s device from the sample covariance
    ``s`` or, given ``x`` (the (rows, p) observations of S = X^T X / rows)
    instead, without forming S: tr(Omega S Omega) = ||Omega X^T||_F^2 /
    rows, so the product is Y = Omega X^T (p x rows) where Cov's is
    Omega S (p x p).  That product is the Omega-side product: with
    ``policy`` on (the solve's own ``MatmulPolicy``, resolved at the
    product's width) it goes through the matops dispatch on Omega's
    observed block occupancy, so a sparse Omega takes the block-sparse
    product (kernel 2 on the card); with ``policy`` None or off it is
    the dense ``om @ s`` or ``om @ x.T``.  The minimum diagonal, g0 and
    the edge count come to the host in one read; a non-positive
    diagonal scores ``inf`` (g0 is then discarded).  Pass ``s=None``
    with ``x``."""
    if (s is None) == (x is None):
        raise ValueError("pseudo_bic takes s or x, not both or neither")
    with span("bic", level="summary"):
        om = torch.as_tensor(omega).to(torch.float64)
        if x is None:
            b = torch.as_tensor(s, device=om.device).to(torch.float64)
        else:
            b = torch.as_tensor(x, device=om.device).to(
                torch.float64).T.contiguous()
        if policy is None or not policy.enabled:
            prod = om @ b
        else:
            prod = matops.matmul(
                om, b, mask=matops.block_mask(om, policy.block_size),
                policy=policy)
        diag = om.diagonal()
        if x is None:
            quad = torch.dot(prod.reshape(-1), om.reshape(-1))
        else:
            quad = torch.dot(prod.reshape(-1), prod.reshape(-1)) / b.shape[1]
        g0 = -torch.log(diag).sum() + 0.5 * quad
        del prod, b  # the product goes before the edge count's pass
        nnz = (om.abs() > tol).sum().to(torch.float64)
        with host_sync(_BIC_SITE):
            min_diag, g0, nnz = torch.stack([diag.min(), g0, nnz]).tolist()
        if min_diag <= 0:
            return float("inf")
        edges = (nnz - om.shape[0]) / 2.0
        return float(2.0 * n * g0 + math.log(max(n, 2)) * edges)


@dataclass(frozen=True)
class PathResult:
    """Result of a regularization path (descending lam1).

    ``mode`` records how the grid ran: ``"sequential"`` (one solve per
    point, optionally warm-started) or ``"batched"`` (the whole grid in
    lock step, ``core.batch``).  ``fit_path(adaptive=True)`` returns the
    STAGE-2 weighted path with ``adaptive=True`` and the stage-1 l1 path
    as ``stage1``.  ``batch_stats`` (batched mode only) is the engine's
    :class:`~repro_torch.core.batch.BatchRunStats`."""
    reports: tuple[FitReport, ...] = field(default_factory=tuple)
    warm_start: bool = True
    mode: str = "sequential"
    adaptive: bool = False
    stage1: "PathResult | None" = None
    batch_stats: object | None = None

    def __post_init__(self):
        object.__setattr__(self, "reports", tuple(self.reports))

    @property
    def lam1_grid(self) -> tuple[float, ...]:
        return tuple(r.lam1 for r in self.reports)

    @property
    def omegas(self) -> list:
        return [r.omega for r in self.reports]

    @property
    def total_iters(self) -> int:
        return int(sum(r.iters for r in self.reports))

    @property
    def total_ls(self) -> int:
        return int(sum(r.ls_total for r in self.reports))

    @property
    def wall_time_s(self) -> float:
        return float(sum(r.wall_time_s for r in self.reports))

    @property
    def telemetry(self) -> dict:
        """Convergence telemetry along the path, one array per field."""
        reps = self.reports
        return {
            "lam1": np.array([r.lam1 for r in reps]),
            "objective": np.array([r.objective for r in reps]),
            "objective_smooth": np.array([r.objective_smooth for r in reps]),
            "iters": np.array([r.iters for r in reps]),
            "ls_total": np.array([r.ls_total for r in reps]),
            "converged": np.array([r.converged for r in reps]),
            "nnz_per_row": np.array([
                np.nan if r.nnz_per_row is None else r.nnz_per_row
                for r in reps]),
            "block_density": np.array([
                np.nan if r.block_density is None else r.block_density
                for r in reps]),
            "wall_time_s": np.array([r.wall_time_s for r in reps]),
        }

    def best_bic(self) -> FitReport:
        """Report with the lowest pseudo-likelihood BIC along the path."""
        scored = [r for r in self.reports if r.bic is not None]
        if not scored:
            raise ValueError("no BIC scores on this path (fit without data?)")
        return min(scored, key=lambda r: r.bic)

    def __len__(self) -> int:
        return len(self.reports)

    def __iter__(self):
        return iter(self.reports)

    def __getitem__(self, i):
        return self.reports[i]

    def summary(self) -> str:
        lines = [r.summary() for r in self.reports]
        how = ("batched" if self.mode == "batched"
               else ("warm" if self.warm_start else "cold") + " starts")
        if self.adaptive:
            how += ", adaptive stage 2"
        lines.append(f"path total: {self.total_iters} outer iters, "
                     f"{self.total_ls} ls trials, {self.wall_time_s:.3f}s "
                     f"({how})")
        if self.batch_stats is not None:
            lines.append(self.batch_stats.summary())
        return "\n".join(lines)


@dataclass(frozen=True)
class GridResult:
    """Result of a (lam1, lam2) grid (``ConcordEstimator.fit_grid``):
    ``paths`` maps each lam2, in the grid's order, to its
    :class:`PathResult` over the descending lam1 grid.  Iterating, or
    ``reports``, gives every point, path by path."""
    paths: dict = field(default_factory=dict)

    @property
    def reports(self) -> tuple[FitReport, ...]:
        return tuple(r for path in self.paths.values() for r in path)

    def best_bic(self) -> FitReport:
        """Report with the lowest pseudo-likelihood BIC over every point
        of every path."""
        scored = [r for r in self.reports if r.bic is not None]
        if not scored:
            raise ValueError("no BIC scores on this grid (score_bic=False?)")
        return min(scored, key=lambda r: r.bic)

    def __len__(self) -> int:
        return len(self.reports)

    def __iter__(self):
        return iter(self.reports)


@dataclass(frozen=True)
class BatchReport:
    """Result of one batched multi-problem solve (``fit_batch``).

    ``reports`` holds one :class:`FitReport` per stacked problem, in input
    order.  The batch ran in lock step, so only the aggregate wall time is
    physical; each report carries its 1/B share.  ``stats`` is the
    engine's :class:`~repro_torch.core.batch.BatchRunStats`."""
    reports: tuple[FitReport, ...] = field(default_factory=tuple)
    wall_time_s: float = 0.0    # end-to-end time of the one batched solve
    stats: object | None = None

    def __post_init__(self):
        object.__setattr__(self, "reports", tuple(self.reports))

    @property
    def n_problems(self) -> int:
        return len(self.reports)

    @property
    def omegas(self) -> list:
        return [r.omega for r in self.reports]

    @property
    def total_iters(self) -> int:
        return int(sum(r.iters for r in self.reports))

    @property
    def all_converged(self) -> bool:
        return all(r.converged for r in self.reports)

    @property
    def any_stalled(self) -> bool:
        return any(r.stalled for r in self.reports)

    def __len__(self) -> int:
        return len(self.reports)

    def __iter__(self):
        return iter(self.reports)

    def __getitem__(self, i):
        return self.reports[i]

    def summary(self) -> str:
        lines = [r.summary() for r in self.reports]
        lines.append(
            f"batch total: {self.n_problems} problems, {self.total_iters} "
            f"outer iters, {self.wall_time_s:.3f}s as one batched solve "
            f"(converged {sum(r.converged for r in self.reports)}"
            f"/{self.n_problems}"
            + (f", stalled {sum(r.stalled for r in self.reports)}"
               if self.any_stalled else "") + ")")
        if self.stats is not None:
            lines.append(self.stats.summary())
        return "\n".join(lines)
