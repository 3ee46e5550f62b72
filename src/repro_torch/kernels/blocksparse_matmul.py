"""Block-sparse x dense product: the CUDA kernel's wrappers.

Port of ``repro.kernels.blocksparse_matmul`` (Pallas ``_kernel``).  One
kernel body (``csrc/blocksparse_matmul.cu``) has two entries:

  * :func:`blocksparse_matmul` keeps the reference's block-CSR contract
    (values (nb, bs, bs), row-major ``row_idx``/``col_idx``; each block-row
    one contiguous run, else ``ValueError``);
  * :func:`masked_matmul` is the sparse branch of the matops dispatch: it
    takes the dense A, its int8 block-occupancy mask, and reads A's
    occupied tiles in place.  No tile list is built on the host or
    gathered on the device.

These wrappers launch on CUDA tensors only; ``kernels.ops`` routes CPU
tensors to the plain versions in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

_DTYPES = (torch.float64, torch.float32)  # ca: allow=CA104 (the f32 build)


def _kernel_fn(entry: str, dtype: torch.dtype):
    lib = build.load("blocksparse_matmul")
    suffix = "f64" if dtype == torch.float64 else "f32"
    fn = getattr(lib, f"bsmm_{entry}_{suffix}")
    p, i = ctypes.c_void_p, ctypes.c_int
    if entry == "csr":   # values, row_ptr, col_idx, bs, b, ldb, c, ldc, M, K, N
        fn.argtypes = [p, p, p, i, p, i, p, i, i, i, i, p]
    else:                # a, lda, mask, nbc, bs, b, ldb, c, ldc, M, K, N
        fn.argtypes = [p, i, p, i, i, p, i, p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype=None) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got one on "
                         f"{t.device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dtype not in _DTYPES + (torch.int8, torch.int32):
        raise TypeError(f"{name}: unsupported dtype {t.dtype}")
    return t.contiguous()


def validate_row_runs(row_idx) -> None:
    """Each block-row id must appear as ONE contiguous run (the
    reference's CA401 contract, ``_validate_row_runs``)."""
    rows = np.asarray(torch.as_tensor(row_idx).cpu())
    if rows.size <= 1:
        return
    change = np.flatnonzero(np.diff(rows) != 0)
    run_starts = rows[np.concatenate(([0], change + 1))]
    uniq, counts = np.unique(run_starts, return_counts=True)
    dupes = uniq[counts > 1]
    if dupes.size:
        raise ValueError(
            f"blocksparse_matmul row_idx revisits block-row(s) "
            f"{dupes.tolist()} non-contiguously: all entries of a "
            f"block-row must form one contiguous run (CSR row-major "
            f"order, see dense_to_block_csr)")


def blocksparse_matmul(values: torch.Tensor, row_idx, col_idx,
                       b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with A in block-CSR ((nb, bs, bs) + row/col block ids).

    b: (p, m) with p a multiple of bs.  Returns (p, m)."""
    validate_row_runs(row_idx)
    b = _check(b, "b")
    values = _check(values, "values", b.dtype)
    nb, bs, bs2 = values.shape
    p, m = b.shape
    if bs != bs2 or p % bs:
        raise ValueError(f"values tiles {tuple(values.shape[1:])} must be "
                         f"square and tile b's {p} rows")
    nbr = p // bs
    rows = np.asarray(torch.as_tensor(row_idx).cpu(), np.int64)
    cols = np.asarray(torch.as_tensor(col_idx).cpu(), np.int64)
    if rows.shape != (nb,) or cols.shape != (nb,):
        raise ValueError(f"row_idx/col_idx must have shape ({nb},)")
    if nb and (rows.min() < 0 or rows.max() >= nbr or cols.min() < 0
               or cols.max() >= nbr):
        raise ValueError(f"block ids out of range [0, {nbr})")
    order = np.argsort(rows, kind="stable")      # runs -> row-major order
    if np.any(order != np.arange(nb)):
        values = values[torch.as_tensor(order, device=values.device)]
        rows, cols = rows[order], cols[order]
    row_ptr = np.zeros(nbr + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=nbr), out=row_ptr[1:])
    row_ptr_d = torch.as_tensor(row_ptr, device=b.device)
    cols_d = torch.as_tensor(cols.astype(np.int32), device=b.device)
    c = torch.empty((p, m), dtype=b.dtype, device=b.device)
    fn = _kernel_fn("csr", b.dtype)
    build.regions("blocksparse_matmul",
                  inputs={"values": values, "row_ptr": row_ptr_d,
                          "col_idx": cols_d, "b": b},
                  outputs={"c": c})
    rc = fn(
        values.data_ptr(), row_ptr_d.data_ptr(),
        cols_d.data_ptr(), bs, b.data_ptr(), m, c.data_ptr(), m, p, p, m,
        torch.cuda.current_stream(b.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"blocksparse_matmul launch failed: "
                           f"cudaError {rc}")
    return c


def masked_matmul(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor, *,
                  block_size: int) -> torch.Tensor:
    """C = A @ B reading only the tiles of A that ``mask`` marks occupied.

    Exact when A is zero outside the occupied tiles (the matops mask of A
    guarantees it).  The kernel visits every occupied tile, so it needs
    no capacity: the dispatch's capacity rungs bound the plain version's
    gather only."""
    b = _check(b, "b")
    a = _check(a, "a", b.dtype)
    mask = _check(mask, "mask", torch.int8)
    M, K = a.shape
    K2, N = b.shape
    bs = block_size
    if K != K2:
        raise ValueError(f"inner dimensions differ: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    nbr, nbc = -(-M // bs), -(-K // bs)
    if tuple(mask.shape) != (nbr, nbc):
        raise ValueError(f"mask shape {tuple(mask.shape)} does not tile a "
                         f"{tuple(a.shape)} at block_size={bs}")
    c = torch.empty((M, N), dtype=b.dtype, device=b.device)
    fn = _kernel_fn("mask", b.dtype)
    build.regions("blocksparse_matmul",
                  inputs={"a": a, "mask": mask, "b": b}, outputs={"c": c})
    rc = fn(
        a.data_ptr(), K, mask.data_ptr(), nbc, bs, b.data_ptr(), N,
        c.data_ptr(), N, M, K, N,
        torch.cuda.current_stream(b.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"masked_matmul launch failed: cudaError {rc}")
    return c
