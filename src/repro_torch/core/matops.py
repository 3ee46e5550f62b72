"""Sparsity-aware matmul dispatch for the Omega-side products (matops).

Port of ``repro.core.matops``.  The iterate Omega becomes very sparse as
the solve proceeds, so the Omega S / Omega X^T product is routed on the
iterate's OBSERVED block occupancy:

  * ``block_mask(a, bs)``  one int8 per bs x bs tile: 1 iff it has a
                           nonzero (the fused prox kernel harvests it for
                           free from its per-tile nnz counts);
  * ``matmul(a, b, mask, policy)``  dense ``a @ b`` above the policy's
                           density threshold, the block-sparse product
                           below it, both exact.

The reference's ``lax.switch`` on the occupied-block count becomes a
Python branch: the count comes to the host once per product (one sync).
On the card the sparse branch is the hand-written block-sparse kernel's
mask entry (``kernels.ops.masked_matmul``); on the CPU it is the plain
block-gather product.  The dense branch is ``a @ b``, which the reference
also leaves to the library (XLA).  ``panel_gram``, the data side's
blocked XᵀX, is a library product too, as in the reference (its dense
``matmul``), accumulated in place into row slabs of the caller's output.
"""
from __future__ import annotations

import bisect
import math
from typing import NamedTuple

import torch

from ..census import host_sync, span
from ..kernels import ops as kops

#: capacity ladder, as fractions of the policy threshold: the dispatch
#: picks the smallest rung whose capacity covers the occupied blocks
TIER_FRACTIONS = (0.125, 0.25, 0.5, 1.0)

#: dtype of every block-occupancy mask; consumers only test ``mask > 0``
MASK_DTYPE = torch.int8

#: dtype of block-density statistics (a diagnostic ratio in [0, 1])
DENSITY_DTYPE = torch.float32


class MatmulPolicy(NamedTuple):
    """Routing policy for Omega-side products.

    mode        "off" — always dense; "on" — block-sparse below
                ``threshold``; "auto" — same mechanics, threshold from the
                cost model's dense <-> block-sparse crossover.
    block_size  tile edge of the occupancy mask (128 on the card).
    threshold   block-density crossover: density above it goes dense.
    """
    mode: str = "off"
    block_size: int = 128
    threshold: float = 0.25

    @property
    def enabled(self) -> bool:
        return self.mode != "off"


DENSE = MatmulPolicy()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def block_mask(a: torch.Tensor, block_size: int) -> torch.Tensor:
    """Block-occupancy mask, shape (cdiv(r, bs), cdiv(c, bs)), int8;
    partial edge tiles are zero-padded (padding never flips a tile on)."""
    r, c = a.shape
    bs = block_size
    nbr, nbc = _cdiv(r, bs), _cdiv(c, bs)
    nz = torch.nn.functional.pad(a != 0, (0, nbc * bs - c, 0, nbr * bs - r))
    return nz.reshape(nbr, bs, nbc, bs).any(dim=3).any(dim=1).to(MASK_DTYPE)


def block_density(mask: torch.Tensor) -> torch.Tensor:
    """Fraction of occupied blocks (``DENSITY_DTYPE`` 0-d tensor)."""
    return (mask > 0).to(DENSITY_DTYPE).mean()


def occupied_blocks(mask: torch.Tensor) -> int:
    """Occupied-block count on the host (one device sync)."""
    with host_sync("core/matops.py:occupied_blocks"):
        return int((mask > 0).sum())


def capacity_tiers(total_blocks: int, threshold: float) -> list[int]:
    """Ascending block capacities the dispatch may use (deduplicated, all
    < total_blocks — a capacity of the full grid saves nothing)."""
    caps = sorted({
        max(1, math.ceil(threshold * total_blocks * f))
        for f in TIER_FRACTIONS
    })
    return [c for c in caps if c < total_blocks]


def select_capacity(caps: list[int], occupied: int) -> int | None:
    """The reference's rung rule: the first rung with capacity >=
    occupied (``searchsorted(side="left")``), or None (dense) past the
    last one."""
    ix = bisect.bisect_left(caps, occupied)
    return caps[ix] if ix < len(caps) else None


def masked_matmul(a, b, mask, *, block_size: int, capacity: int):
    """C = A @ B over the occupied tiles of A (exact when the occupied
    count is <= ``capacity``): the kernel on the card, the block-gather
    plain version on the CPU."""
    return kops.masked_matmul(a, b, mask, block_size=block_size,
                              capacity=capacity)


def matmul(a: torch.Tensor, b: torch.Tensor, *, mask=None,
           policy: MatmulPolicy | None = None) -> torch.Tensor:
    """The Omega-side product dispatch.

    Dense ``a @ b`` when the policy is off or no mask is given; otherwise
    the occupied-block count of ``mask`` picks the block-sparse product
    with the smallest covering capacity rung, or dense past the last rung
    (occupied > ceil(threshold * total)).  Counts are integers, so no
    rounding of a density ratio can under-select a rung."""
    if policy is None or not policy.enabled or mask is None:
        return _dense(a, b)
    bs = policy.block_size
    nbr, nbc = _cdiv(a.shape[0], bs), _cdiv(a.shape[1], bs)
    if tuple(mask.shape) != (nbr, nbc):
        raise ValueError(
            f"mask shape {tuple(mask.shape)} does not tile operand "
            f"{tuple(a.shape)} at block_size={bs} (want {(nbr, nbc)})")
    caps = capacity_tiers(nbr * nbc, policy.threshold)
    if not caps:
        return _dense(a, b)
    cap = select_capacity(caps, occupied_blocks(mask))
    if cap is None:
        return _dense(a, b)
    with span("matmul.sparse"):
        return masked_matmul(a, b, mask, block_size=bs, capacity=cap)


def _dense(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The dispatch's dense branch."""
    with span("matmul.dense"):
        return a @ b


def panel_gram(x: torch.Tensor, *, panel: int = 512,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Blocked XᵀX of an (n, p) row-block, by column panels: each product
    is a bounded (panel, n) @ (n, p) slab added in place into rows
    [lo, lo + panel) of ``out`` (``xx[lo:hi].addmm_(x[:, lo:hi].T, x)``),
    so no second (p, p) buffer exists.  ``out=None`` starts from zeros
    and returns the Gram; a given ``out`` (p, p) of x's dtype and device
    is accumulated into and returned — the unit of work the streaming
    Gram accumulator (``data.gram``) folds per chunk.  The product runs
    in x's dtype: the accumulator casts its chunk to float64 first."""
    if panel < 1:
        raise ValueError(f"panel must be >= 1, got {panel}")
    if x.ndim != 2:
        raise ValueError(f"x must be 2-D (n, p), got shape {tuple(x.shape)}")
    p = x.shape[1]
    if out is None:
        out = torch.zeros((p, p), dtype=x.dtype, device=x.device)
    elif tuple(out.shape) != (p, p):
        raise ValueError(f"out must be ({p}, {p}), got {tuple(out.shape)}")
    for lo in range(0, p, panel):
        out[lo:lo + panel].addmm_(x[:, lo:lo + panel].T, x)
    return out
