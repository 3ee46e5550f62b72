"""The work each operation needs at given inputs: floating-point
operations and bytes, counted from shapes and nonzeros, never from how
an implementation tiles or pads them.  Every input byte is read once and
every output byte written once; a matrix entry is a float64 of 8 bytes.
Each module holds one operation's count; ``least_seconds`` turns a count
into the least time a chip with the given peaks could take.
"""
from __future__ import annotations

WORD = 8


def least_seconds(flops: float, nbytes: float, peaks: dict) -> float:
    """The larger of flops over the peak rate and bytes over the peak
    bandwidth (``peaks`` from ``hpbench.harness.peaks``)."""
    return max(flops / peaks["flops_per_s"], nbytes / peaks["bytes_per_s"])
