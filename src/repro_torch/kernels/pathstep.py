"""Fused path step of the batched lambda-path engine: the CUDA kernel's
wrapper.

Port of ``repro.kernels.pathstep`` (Pallas ``_kernel`` and
``_kernel_weighted``).  One launch of ``csrc/pathstep.cu`` runs one flat
step for all C lanes: the gradient from the cached product W = Omega S,
the prox candidate at each lane's step size, and the per-lane acceptance
sums, in one pass over the lane-stacked state.  Only the candidate's new
product (a GEMM) and its smooth objective stay outside.

This wrapper launches the kernel on CUDA tensors only; ``kernels.ops``
routes CPU tensors to the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import PATH_STEP_STATS

#: the reference's preferred tile edge, kept as the wrapper's ``block``
#: argument for parity; the CUDA kernel's tile is fixed (32 x 32) and
#: masks ragged edge tiles itself, so any p runs without a fallback
DEFAULT_BLOCK = 256

#: output tile edge of ``csrc/pathstep.cu`` (``kTile``): one partials row
#: per tile
TILE = 32

_DTYPES = (torch.float64, torch.float32)  # ca: allow=CA104 (the f32 build)


def _kernel_fn(dtype: torch.dtype):
    lib = build.load("pathstep")
    suffix = "f64" if dtype == torch.float64 else "f32"
    fn = getattr(lib, f"fused_path_step_{suffix}")
    p = ctypes.c_void_p
    # om, w, weights, weights lane stride, scal, cand, partials, stats,
    # c, p, stream
    fn.argtypes = [p, p, p, ctypes.c_longlong, p, p, p, p, ctypes.c_int,
                   ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, like: torch.Tensor, shapes) -> None:
    if not isinstance(t, torch.Tensor) or t.device != like.device:
        raise ValueError(f"{name} must be a tensor on {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name} must be {like.dtype}, got {t.dtype}")
    if tuple(t.shape) not in shapes:
        raise ValueError(f"{name} shape {tuple(t.shape)} must be one of "
                         f"{sorted(shapes)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _lane_vector(name: str, v, c: int, like: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    if t.ndim > 1 or (t.ndim == 1 and t.shape[0] != c):
        raise ValueError(f"{name} must be a scalar or ({c},), got shape "
                         f"{tuple(t.shape)}")
    return t.expand(c)


def fused_path_step(omega: torch.Tensor, w: torch.Tensor, tau, lam1, lam2,
                    *, weights=None, block: int = DEFAULT_BLOCK):
    """Launch the fused path step on CUDA tensors.

    ``omega``/``w``: contiguous (C, p, p) iterates and products;
    ``tau``/``lam1``/``lam2``: scalars or (C,) per-lane values (they stay
    on the card: the (C, 3) table ``[tau, tau * lam1, lam2]`` is built
    there, with no host sync); ``weights``: None, one shared (p, p) or
    per-lane (C, p, p).  Returns ``(cand, stats)`` like
    ``kernels.ref.fused_path_step``."""
    if not isinstance(omega, torch.Tensor) or omega.device.type != "cuda":
        raise ValueError("the CUDA path step takes CUDA tensors, got omega "
                         f"on {getattr(omega, 'device', type(omega))}")
    if omega.dtype not in _DTYPES:
        raise TypeError(f"the CUDA path step supports float32/float64, got "
                        f"{omega.dtype}")
    if omega.ndim != 3 or omega.shape[1] != omega.shape[2]:
        raise ValueError(f"omega must be (C, p, p), got "
                         f"{tuple(omega.shape)}")
    if int(block) < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    c, p, _ = omega.shape
    _check("omega", omega, omega, {(c, p, p)})
    _check("w", w, omega, {(c, p, p)})
    stride = 0
    if weights is not None:
        _check("weights", weights, omega, {(c, p, p), (p, p)})
        stride = p * p if weights.ndim == 3 else 0
    tau_v = _lane_vector("tau", tau, c, omega)
    scal = torch.stack([tau_v, tau_v * _lane_vector("lam1", lam1, c, omega),
                        _lane_vector("lam2", lam2, c, omega)], dim=1)
    scal = scal.contiguous()
    g = -(-p // TILE)
    cand = torch.empty_like(omega)
    partials = torch.empty((c, g, g, PATH_STEP_STATS), dtype=torch.float64,
                           device=omega.device)
    stats = torch.empty((c, PATH_STEP_STATS), dtype=omega.dtype,
                        device=omega.device)
    fn = _kernel_fn(omega.dtype)
    build.regions("pathstep", inputs={"omega": omega, "w": w,
                                      "weights": weights, "scal": scal},
                  outputs={"cand": cand, "stats": stats},
                  scratch={"partials": partials})
    rc = fn(omega.data_ptr(), w.data_ptr(),
            None if weights is None else weights.data_ptr(), stride,
            scal.data_ptr(), cand.data_ptr(), partials.data_ptr(),
            stats.data_ptr(), c, p,
            torch.cuda.current_stream(omega.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_path_step launch failed: cudaError {rc}")
    return cand, stats
