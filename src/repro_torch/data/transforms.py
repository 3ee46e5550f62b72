"""Pluggable per-chunk transforms for the streaming Gram pipeline.

Port of ``repro.data.transforms``.  A transform decides what matrix the
Gram is taken OF, without the pipeline ever materializing that matrix:

  ``none``         S = XᵀX / n                     (raw second moment)
  ``center``       S = (X-μ)ᵀ(X-μ) / n            (covariance)
  ``standardize``  S = correlation matrix          (center + unit scale)
  ``rank``         S = ZᵀZ / n with z_ij = Φ⁻¹((rank_j(x_ij)-½)/n), each
                   column rescaled to unit variance — the nonparanormal
                   transform: S is invariant under ANY strictly monotone
                   distortion of the marginals.

``none``/``center``/``standardize`` are *moment transforms*: the
accumulator streams raw f64 moments (Welford mean/variance + ΣXᵀX) in ONE
pass and the transform is applied algebraically at ``finalize()``:

    S_center = ΣXᵀX/n − μμᵀ          S_std[i,j] = S_center[i,j]/(σ_i σ_j)

Both run in place on the one (p, p) result (a rank-1 update and two
broadcast divides), so finalizing allocates no second p x p buffer.

``rank`` is order-based and runs in the bounded two-pass mode of
``gram.rank_gram``.  Its scores are computed on the device a column panel
at a time: one sort per column, tied runs found by a segmented scan and
given their group's mean rank (exact in f64), Φ⁻¹ by
``torch.special.ndtri``.

Stats and Grams are float64 tensors on the accumulator's device.
``register_transform`` plugs in new names without touching the
accumulator.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

__all__ = [
    "StreamStats", "Transform", "available_transforms", "average_ranks",
    "get_transform", "rank_transform_column", "rank_transform_panel",
    "register_transform",
]

#: columns with population std below this are treated as constant (scale 1)
#: by ``standardize`` so a degenerate column cannot NaN the whole Gram.
STD_FLOOR = 1e-12


class StreamStats(NamedTuple):
    """One-pass f64 stream moments of the raw data (the accumulator's
    finalized state): everything a moment transform needs."""
    n: int                  # rows seen
    mean: torch.Tensor      # (p,) column means
    var: torch.Tensor       # (p,) population variances (M2 / n)
    xx: torch.Tensor        # (p, p) RAW second-moment sum  Σ xᵀx  (not /n)

    @property
    def std(self) -> torch.Tensor:
        sd = torch.sqrt(self.var.clamp_min(0.0))
        return torch.where(sd < STD_FLOOR, torch.ones_like(sd), sd)


@dataclass(frozen=True)
class Transform:
    """A named Gram transform.

    ``finalize_gram(stats)`` turns one-pass stream moments into a NEW
    (p, p) Gram of the transformed data (moment transforms only —
    ``two_pass`` transforms raise here and are handled by
    ``gram.rank_gram``).  ``apply(chunk, stats)`` maps a raw chunk into
    transformed coordinates given full-data stats.
    """
    name: str
    two_pass: bool = False
    _finalize: Callable | None = None
    _apply: Callable | None = None

    def finalize_gram(self, stats: StreamStats) -> torch.Tensor:
        if self.two_pass or self._finalize is None:
            raise ValueError(
                f"transform {self.name!r} is order-based (two-pass); "
                f"stream it through gram.rank_gram / compute_gram, not "
                f"GramAccumulator.finalize")
        return self._finalize(stats)

    def apply(self, chunk, stats: StreamStats) -> torch.Tensor:
        if self._apply is None:
            raise ValueError(
                f"transform {self.name!r} has no per-chunk application "
                f"(rank scores depend on the whole sample, not one chunk)")
        x = torch.as_tensor(chunk, device=stats.mean.device)
        return self._apply(x.to(torch.float64), stats)


# ---------------------------------------------------------------------------
# moment transforms
# ---------------------------------------------------------------------------

def _finalize_none(st: StreamStats) -> torch.Tensor:
    return st.xx / st.n


def _finalize_center(st: StreamStats) -> torch.Tensor:
    return _finalize_none(st).addr_(st.mean, st.mean, alpha=-1.0)


def _finalize_standardize(st: StreamStats) -> torch.Tensor:
    sd = st.std
    return _finalize_center(st).div_(sd[:, None]).div_(sd[None, :])


# ---------------------------------------------------------------------------
# rank / nonparanormal
# ---------------------------------------------------------------------------

def _average_ranks_panel(x: torch.Tensor) -> torch.Tensor:
    """Average ranks in [1, n] of each column of an (n, w) panel, ties
    sharing their group's mean (the Spearman convention), float64.

    One sort per column; a tied run is a segment of the sorted column
    whose first and last positions come from a running max / min over
    the segment starts / ends.  Every value is (first + last) / 2 of two
    integers below 2^53, so the result is exact."""
    n, w = x.shape
    vals, order = torch.sort(x, dim=0, stable=True)
    pos = torch.arange(n, device=x.device, dtype=torch.int64)[:, None]
    pos = pos.expand(n, w)
    new = torch.ones((n, w), dtype=torch.bool, device=x.device)
    new[1:] = vals[1:] != vals[:-1]
    last = torch.ones_like(new)
    last[:-1] = new[1:]
    first = torch.where(new, pos, 0).cummax(dim=0).values
    end = torch.where(last, pos, n - 1).flip(0).cummin(dim=0).values.flip(0)
    avg = (first + end + 2).to(torch.float64) / 2.0
    return torch.empty_like(avg).scatter_(0, order, avg)


def average_ranks(col: torch.Tensor) -> torch.Tensor:
    """Average ranks in [1, n] of a 1-D tensor, ties sharing their group
    mean (``repro.data.transforms.average_ranks``); exact."""
    return _average_ranks_panel(torch.as_tensor(col)[:, None])[:, 0]


def rank_transform_panel(x: torch.Tensor) -> torch.Tensor:
    """Nonparanormal scores of every column of an (n, w) panel:
    z = Φ⁻¹((rank - ½)/n), each column rescaled to exactly unit
    population variance (an all-tied column scores all zeros)."""
    n = x.shape[0]
    z = torch.special.ndtri((_average_ranks_panel(x) - 0.5) / n)
    sd = torch.sqrt(z.square().mean(0) - z.mean(0).square())
    keep = sd >= STD_FLOOR
    return torch.where(keep, z / torch.where(keep, sd, 1.0), 0.0)


def rank_transform_column(col: torch.Tensor) -> torch.Tensor:
    """Nonparanormal scores of one column (see
    :func:`rank_transform_panel`); depends on the ORDER of the values
    only."""
    return rank_transform_panel(torch.as_tensor(col)[:, None])[:, 0]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Transform] = {}


def register_transform(tf: Transform, *, overwrite: bool = False) -> None:
    if not overwrite and tf.name in _REGISTRY:
        raise ValueError(f"transform {tf.name!r} already registered")
    _REGISTRY[tf.name] = tf


def get_transform(name: str | Transform) -> Transform:
    if isinstance(name, Transform):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown transform {name!r}; available: "
            f"{available_transforms()}") from None


def available_transforms() -> list[str]:
    return sorted(_REGISTRY)


register_transform(Transform(
    "none", _finalize=_finalize_none,
    _apply=lambda c, st: c))
register_transform(Transform(
    "center", _finalize=_finalize_center,
    _apply=lambda c, st: c - st.mean))
register_transform(Transform(
    "standardize", _finalize=_finalize_standardize,
    _apply=lambda c, st: (c - st.mean) / st.std))
register_transform(Transform("rank", two_pass=True))
