"""repro_torch.estimator — the public API of the PyTorch port.

    from repro_torch.estimator import ConcordEstimator, SolverConfig
    from repro_torch.core.penalty import PenaltySpec

    est = ConcordEstimator(penalty=PenaltySpec.l1(0.3, 0.05),
                           config=SolverConfig(backend="reference",
                                               use_pallas=True,
                                               sparse_matmul="on"))
    est.fit_cov(S, n_samples=n)     # -> est.omega_, est.report_
    path = est.fit_path(X, lam1_grid=[0.3, 0.2, 0.15])
    best = path.best_bic()
    path = est.fit_path(X, lam1_grid=[0.3, 0.2, 0.15], mode="batched")
    batch = fit_batch(s=S_stack, lam1=[0.2, 0.3], device="cpu")

Runs on the CUDA card unless ``SolverConfig(device="cpu")``.  Under a
process group (``repro_torch.comm.init_process_group``, or torchrun),
``backend="distributed"`` and ``"auto"`` solve on the 1.5D grid of its
ranks: every rank calls the same fits with the same data.
"""
from ..core.penalty import (  # noqa: F401
    PenaltySpec,
    adaptive_weights,
    as_penalty,
    parse_penalty,
    penalty_kinds,
    register_penalty,
)
from .backends import (  # noqa: F401
    Problem,
    auto_backend,
    available_backends,
    distributed_backend,
    get_backend,
    reference_backend,
    register_backend,
)
from .batch import batch_reports, batched_path_reports, fit_batch  # noqa: F401
from .config import SolverConfig  # noqa: F401
from .estimator import ConcordEstimator, fit, fit_path  # noqa: F401
from .report import (  # noqa: F401
    BatchReport,
    FitReport,
    PathResult,
    pseudo_bic,
)

__all__ = [
    "BatchReport",
    "ConcordEstimator",
    "FitReport",
    "PathResult",
    "PenaltySpec",
    "Problem",
    "SolverConfig",
    "adaptive_weights",
    "as_penalty",
    "auto_backend",
    "available_backends",
    "batch_reports",
    "batched_path_reports",
    "distributed_backend",
    "fit",
    "fit_batch",
    "fit_path",
    "get_backend",
    "parse_penalty",
    "penalty_kinds",
    "pseudo_bic",
    "reference_backend",
    "register_backend",
    "register_penalty",
]
