"""The fused proximal step of one line-search trial (kernel 1's work):
soft-threshold every off-diagonal entry of the (p x p) point z, keep the
diagonal, and sum the trial's statistics (log of the diagonal, the
off-diagonal l1 norm, the sum of squares, the least diagonal entry, the
nonzeros of each ``block`` x ``block`` tile).

Bytes: z read once and the (p x p) result written once; the statistics
are five numbers per tile.  Flops: 3 per entry for the threshold (|z| -
alpha, the clamp, the sign) and 4 per entry for the sums.
"""
from __future__ import annotations

from . import WORD

FLOPS_PER_ENTRY = 7


def flops(p: int) -> float:
    return FLOPS_PER_ENTRY * float(p) * p


def bytes_moved(p: int, block: int = 128) -> float:
    tiles = (-(-p // block)) ** 2
    return WORD * (2.0 * p * p + 5.0 * tiles)
