"""A product of the sparse iterate Omega (p x p, ``nnz`` nonzeros) with a
dense (p x m) operand into a dense (p x m) output.

Each nonzero of Omega meets one row of the operand: 2 nnz m flops.  The
bytes are Omega's nonzero values, the operand read once and the output
written once; index arrays are not counted, so the count is a floor.
"""
from __future__ import annotations

from . import WORD


def flops(p: int, m: int, nnz: float) -> float:
    return 2.0 * nnz * m


def bytes_moved(p: int, m: int, nnz: float) -> float:
    return WORD * (nnz + 2.0 * p * m)


def dense_flops(p: int, k: int, m: int) -> float:
    """A dense (p x k) by (k x m) product: 2 p k m flops."""
    return 2.0 * p * k * m


def dense_bytes(p: int, k: int, m: int) -> float:
    return WORD * (p * k + k * m + p * m)
