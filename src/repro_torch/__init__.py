"""HP-CONCORD on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

The package mirrors ``repro``'s layout so each module's counterpart is
easy to find:

  core/       objective, penalties, graphs, cost model, the matops
              dispatch and the proximal-gradient loop
  kernels/    hand-written CUDA kernels for Hopper (``csrc/``), their
              plain PyTorch versions (``ref``) and the device dispatch
              (``ops``)
  estimator/  ``ConcordEstimator``, ``SolverConfig``, the backend
              registry and the fit reports
  convert     carries problems, penalties and configs across packages

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).  The package imports
``torch``, numpy and the standard library only.
"""
from .device import resolve_device  # noqa: F401
