"""Fused proximal update + line-search statistics: the CUDA kernel's wrapper.

Port of ``repro.kernels.softthresh`` (Pallas ``_kernel`` and
``_kernel_weighted``).  The kernel (``csrc/softthresh.cu``) computes, in
one pass over z, ``out = S_alpha(z)`` off the diagonal and ``z`` on it,
plus per-tile partials of the line-search statistics; with the tile equal
to the matops block size, the per-tile nonzero counts are the block-
occupancy mask the sparse product dispatch consumes.

The trial entry (:func:`fused_prox_trial`) is one line-search trial of
the prox loop in one pass: it reads Omega and the gradient, forms ``z =
omega - tau * grad`` in registers, writes the prox of z once, and returns
the trial's step norms, the candidate's squared norm and the same per-tile
nonzero counts.

These wrappers launch the kernels on CUDA tensors only; ``kernels.ops``
routes CPU tensors to the plain versions in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

#: tile of the stats grid; the solver passes the matops block size
DEFAULT_BLOCK = (128, 128)

_ARGTYPES = {
    torch.float64: ctypes.c_double,
    torch.float32: ctypes.c_float,  # ca: allow=CA104 (the f32 build)
}


def _kernel_fn(entry: str, dtype: torch.dtype, scalars: int = 1):
    """The C entry ``<entry>_f64|f32`` typed as (pointers..., ``scalars``
    scalars, out, stats, m, n, bm, bn, stream)."""
    lib = build.load("softthresh")
    suffix = "f64" if dtype == torch.float64 else "f32"
    fn = getattr(lib, f"{entry}_{suffix}")
    scalar = _ARGTYPES[dtype]
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, *[scalar] * scalars, p, p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn, scalar


def _check_iterate(z: torch.Tensor) -> None:
    if z.device.type != "cuda":
        raise ValueError(f"the CUDA fused prox takes a CUDA tensor, got "
                         f"one on {z.device}")
    if z.dtype not in _ARGTYPES:
        raise TypeError(f"the CUDA fused prox supports float32/float64, "
                        f"got {z.dtype}")
    if z.ndim != 2:
        raise ValueError(f"z must be 2-D, got shape {tuple(z.shape)}")


def _grid(z: torch.Tensor, block) -> tuple:
    """(bm, bn, gm, gn): the stats tile clipped to z, and the grid."""
    m, n = z.shape
    bm, bn = min(block[0], m), min(block[1], n)
    return bm, bn, -(-m // bm), -(-n // bn)


def _operand(name: str, t, z: torch.Tensor) -> torch.Tensor | None:
    if t is None:
        return None
    t = torch.as_tensor(t, dtype=z.dtype, device=z.device)
    if t.shape != z.shape:
        raise ValueError(f"{name} shape {tuple(t.shape)} must match the "
                         f"iterate shape {tuple(z.shape)}")
    return t.contiguous()


def fused_prox_stats(z: torch.Tensor, diag_mask, alpha, *, weights=None,
                     block=DEFAULT_BLOCK):
    """Launch the fused prox kernel on a CUDA tensor.

    Returns (out, logdet, l1_offdiag, sumsq, min_diag, block_nnz) like
    ``kernels.ref.fused_prox_stats``.  ``diag_mask=None`` exempts the
    main diagonal without reading a mask."""
    _check_iterate(z)
    z = z.contiguous()
    dm = _operand("diag_mask", diag_mask, z)
    w = _operand("weights", weights, z)
    m, n = z.shape
    bm, bn, gm, gn = _grid(z, block)
    out = torch.empty_like(z)
    stats = torch.empty((gm, gn, 5), dtype=z.dtype, device=z.device)
    fn, scalar = _kernel_fn("fused_prox_stats", z.dtype)
    build.regions("softthresh", inputs={"z": z, "diag_mask": dm,
                                        "weights": w},
                  outputs={"out": out, "stats": stats})
    rc = fn(z.data_ptr(), None if dm is None else dm.data_ptr(),
            None if w is None else w.data_ptr(), scalar(float(alpha)),
            out.data_ptr(), stats.data_ptr(), m, n, bm, bn,
            torch.cuda.current_stream(z.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_prox_stats launch failed: cudaError {rc}")
    return (out, stats[..., 0].sum(), stats[..., 1].sum(),
            stats[..., 2].sum(), stats[..., 3].min(), stats[..., 4])


def fused_prox_trial(omega: torch.Tensor, grad, tau, alpha, *,
                     weights=None, block=DEFAULT_BLOCK):
    """Launch the fused prox's trial entry on a CUDA tensor.

    Returns (out, diff_sq, diff_grad, sumsq, block_nnz) like
    ``kernels.ref.fused_prox_trial``: the prox of ``omega - tau * grad``
    at threshold ``alpha`` (the main diagonal exempt), ``<d, d>`` and
    ``<d, grad>`` for ``d = out - omega``, ``||out||^2``, and the per-tile
    nonzero counts."""
    _check_iterate(omega)
    omega = omega.contiguous()
    g = _operand("grad", grad, omega)
    w = _operand("weights", weights, omega)
    m, n = omega.shape
    bm, bn, gm, gn = _grid(omega, block)
    out = torch.empty_like(omega)
    stats = torch.empty((gm, gn, 4), dtype=omega.dtype, device=omega.device)
    fn, scalar = _kernel_fn("fused_prox_trial", omega.dtype, scalars=2)
    build.regions("softthresh", inputs={"omega": omega, "grad": g,
                                        "weights": w},
                  outputs={"out": out, "stats": stats})
    rc = fn(omega.data_ptr(), g.data_ptr(),
            None if w is None else w.data_ptr(), scalar(float(tau)),
            scalar(float(alpha)), out.data_ptr(), stats.data_ptr(), m, n,
            bm, bn, torch.cuda.current_stream(omega.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_prox_trial launch failed: cudaError {rc}")
    sums = stats[..., :3].sum(dim=(0, 1))
    return out, sums[0], sums[1], sums[2], stats[..., 3]
