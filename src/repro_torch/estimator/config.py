"""Solver configuration for the ``repro_torch.estimator`` facade.

Port of ``repro.estimator.config``: the same frozen, validated
``SolverConfig`` with the same field names and values, plus ``device``.
``obs`` takes the reference's levels (``repro_torch.obs``).

``use_pallas`` keeps its name as a knob; in the port it means "use the
hand-written CUDA kernels" (the fused prox and its occupancy harvest, and
the batched engine's fused path step).  ``batch_gemm`` keeps the
reference's values: ``"xla"`` is the product on the solve's device,
``"host"`` through ``np.matmul`` on a host copy.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from ..core.penalty import parse_penalty
from ..core.prox import TAU_SCHEDULES

VARIANTS = ("auto", "cov", "obs")

SPARSE_MATMUL_MODES = ("off", "on", "auto")

_DTYPES = ("float32", "float64", "bfloat16")

BATCH_SCHEDULES = ("compact", "monolithic")

BATCH_GEMMS = ("auto", "xla", "host")

BATCH_WARM_STARTS = (None, "pilot")

OBS_MODES = ("off", "summary", "trace")


@dataclass(frozen=True)
class SolverConfig:
    """Every knob of a CONCORD solve, in one place (see
    ``repro.estimator.config.SolverConfig`` for each field).

    device     where the solve runs: ``None`` (the CUDA card; raises if
               there is none), ``"cuda"``, ``"cuda:1"`` or ``"cpu"``; under
               a process group, this rank's device.
    n_devices  processes of the 1.5D grid; ``None`` is the process
               group's world size (1 outside one).
    obs        runtime observability (``repro_torch.obs``): ``"off"``
               (the obs package is never imported), ``"summary"`` (a
               span per solve, the solve metrics, ``FitReport.telemetry``)
               or ``"trace"`` (adds the dispatch / execute split and, on
               the distributed backend's dense path, the comm
               reconciliation); the estimate is the same at every level.
    """
    backend: str = "auto"
    variant: str = "auto"
    c_x: int | None = None
    c_omega: int | None = None
    n_devices: int | None = None
    tol: float = 1e-5
    max_iters: int = 500
    max_ls: int = 30
    warm_start_tau: bool = False
    dtype: str | None = None
    use_pallas: bool = False
    sparse_matmul: str = "off"
    sparse_block: int = 128
    sparse_threshold: float | None = None
    penalty: str = "l1"
    tau_schedule: str | None = None
    batch_schedule: str = "compact"
    batch_chunk: int = 32
    batch_max_lanes: int | None = None
    batch_gemm: str = "auto"
    batch_warm_start: str | None = None
    obs: str = "off"
    device: str | None = None

    def __post_init__(self):
        if not isinstance(self.backend, str) or not self.backend:
            raise ValueError(f"backend must be a non-empty string, got "
                             f"{self.backend!r}")
        if self.variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got "
                             f"{self.variant!r}")
        for name in ("c_x", "c_omega"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int) or v < 1):
                raise ValueError(f"{name} must be a positive int or None, "
                                 f"got {v!r}")
        if self.n_devices is not None and self.n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {self.n_devices}")
        if not (self.tol > 0.0):
            raise ValueError(f"tol must be > 0, got {self.tol}")
        if self.max_iters < 1:
            raise ValueError(f"max_iters must be >= 1, got {self.max_iters}")
        if self.max_ls < 1:
            raise ValueError(f"max_ls must be >= 1, got {self.max_ls}")
        if self.dtype is not None and self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {_DTYPES} or None, got "
                             f"{self.dtype!r}")
        if self.sparse_matmul not in SPARSE_MATMUL_MODES:
            raise ValueError(f"sparse_matmul must be one of "
                             f"{SPARSE_MATMUL_MODES}, got "
                             f"{self.sparse_matmul!r}")
        if not isinstance(self.sparse_block, int) or self.sparse_block < 1:
            raise ValueError(f"sparse_block must be a positive int, got "
                             f"{self.sparse_block!r}")
        if self.sparse_threshold is not None and not (
                0.0 < self.sparse_threshold <= 1.0):
            raise ValueError(f"sparse_threshold must be in (0, 1] or None, "
                             f"got {self.sparse_threshold!r}")
        if self.tau_schedule is not None and \
                self.tau_schedule not in TAU_SCHEDULES:
            raise ValueError(f"tau_schedule must be one of {TAU_SCHEDULES} "
                             f"or None, got {self.tau_schedule!r}")
        if self.batch_schedule not in BATCH_SCHEDULES:
            raise ValueError(f"batch_schedule must be one of "
                             f"{BATCH_SCHEDULES}, got "
                             f"{self.batch_schedule!r}")
        if not isinstance(self.batch_chunk, int) or self.batch_chunk < 1:
            raise ValueError(f"batch_chunk must be a positive int, got "
                             f"{self.batch_chunk!r}")
        if self.batch_max_lanes is not None and (
                not isinstance(self.batch_max_lanes, int)
                or self.batch_max_lanes < 1):
            raise ValueError(f"batch_max_lanes must be a positive int or "
                             f"None, got {self.batch_max_lanes!r}")
        if self.batch_gemm not in BATCH_GEMMS:
            raise ValueError(f"batch_gemm must be one of {BATCH_GEMMS}, "
                             f"got {self.batch_gemm!r}")
        if self.batch_warm_start not in BATCH_WARM_STARTS:
            raise ValueError(f"batch_warm_start must be one of "
                             f"{BATCH_WARM_STARTS}, got "
                             f"{self.batch_warm_start!r}")
        if self.obs not in OBS_MODES:
            raise ValueError(f"obs must be one of {OBS_MODES}, got "
                             f"{self.obs!r}")
        if not isinstance(self.penalty, str):
            raise ValueError(
                f"config.penalty must be a penalty string form (got "
                f"{type(self.penalty).__name__}); pass PenaltySpec objects "
                f"to the estimator, not the config")
        parse_penalty(self.penalty)     # raises ValueError on bad forms
        if self.device is not None and not isinstance(self.device, str):
            raise ValueError(f"device must be a string or None, got "
                             f"{self.device!r}")

    def replace(self, **changes) -> "SolverConfig":
        """Functional update (frozen dataclass)."""
        return dataclasses.replace(self, **changes)
