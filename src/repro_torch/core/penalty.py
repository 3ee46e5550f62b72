"""Composable penalties: pluggable elementwise prox operators, in torch.

The port of ``repro.core.penalty``.  A :class:`PenaltySpec` is a plain
frozen dataclass (no pytree): the kind selects the prox formula, the
numeric fields are Python floats, and ``weights`` is a (p, p) array or
tensor that the solver moves to its device once per solve.

Built-in kinds, with the reference's semantics:

  ``l1``           lam1 * ||offdiag||_1 (+ the smooth lam2 ridge in g)
  ``elastic_net``  the same operator under its explicit name
  ``weighted_l1``  lam1 * sum_ij w_ij |omega_ij|; ``w = 0`` leaves an entry
                   unpenalized, ``w = inf`` forces it to exactly zero
  ``scad``         Fan & Li's SCAD, shape ``a > 2`` (default 3.7)
  ``mcp``          Zhang's MCP, shape ``gamma > 1`` (default 3.0)

Lane-batched specs (the batched engine, ``core.batch``): any numeric
field may carry a leading (B,) lane axis (a (B,) ``lam1`` or ``shape``, a
(B, p, p) ``weights``); ``batch_axes`` says which do and ``lane(i, b)``
picks one lane.  The prox then runs on lane-stacked (C, p, p) operands,
with each (C,) parameter seen as a (C, 1, 1) view (:func:`lane_view`).
``adaptive_weights`` builds the stage-2 weights of the adaptive lasso.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .objective import offdiag_l1, soft_threshold as _soft

#: default SCAD shape parameter (Fan & Li's canonical choice)
SCAD_DEFAULT_A = 3.7

#: default MCP shape parameter
MCP_DEFAULT_GAMMA = 3.0

#: relative asymmetry above this rejects a weight matrix
WEIGHT_SYMMETRY_RTOL = 1e-6


def lane_view(v, like: torch.Tensor):
    """A per-lane (C,) tensor as a (C, 1, 1) view against a lane-stacked
    (C, p, p) operand ``like``; scalars, 0-d tensors and full-shape
    operands pass through unchanged."""
    if isinstance(v, torch.Tensor) and v.ndim == 1 and like.ndim == 3:
        return v.view(-1, 1, 1)
    return v


def _weights_like(spec, z):
    return torch.as_tensor(spec.weights, dtype=z.dtype, device=z.device)


# ---------------------------------------------------------------------------
# per-kind prox / value implementations
#
# prox(spec, z, tau) returns the UNMASKED elementwise prox of tau * penalty;
# the caller applies the diagonal exemption.
# ---------------------------------------------------------------------------

def _prox_l1(spec, z, tau):
    return _soft(z, lane_view(tau, z) * lane_view(spec.lam1, z))


def weighted_threshold(alpha, w: torch.Tensor) -> torch.Tensor:
    """alpha * w with inf weights forcing an inf threshold even at
    alpha == 0 (inf * 0 = nan)."""
    thr = alpha * w
    return torch.where(torch.isinf(w), torch.full_like(thr, math.inf), thr)


def _prox_weighted_l1(spec, z, tau):
    alpha = lane_view(tau, z) * lane_view(spec.lam1, z)
    return _soft(z, weighted_threshold(alpha, _weights_like(spec, z)))


def _prox_scad(spec, z, tau):
    a, lam = lane_view(spec.shape, z), lane_view(spec.lam1, z)
    tau = lane_view(tau, z)
    az = torch.abs(z)
    inner = _soft(z, tau * lam)
    mid = ((a - 1.0) * z - torch.sign(z) * (tau * a * lam)) / (a - 1.0 - tau)
    return torch.where(az <= (1.0 + tau) * lam, inner,
                       torch.where(az <= a * lam, mid, z))


def _prox_mcp(spec, z, tau):
    gamma, lam = lane_view(spec.shape, z), lane_view(spec.lam1, z)
    tau = lane_view(tau, z)
    az = torch.abs(z)
    shrunk = (gamma / (gamma - tau)) * _soft(z, tau * lam)
    return torch.where(az <= gamma * lam, shrunk, z)


def _offdiag_sum(vals: torch.Tensor) -> torch.Tensor:
    return vals.sum() - vals.diagonal().sum()


def _value_l1(spec, om):
    return spec.lam1 * _offdiag_sum(torch.abs(om))


def _value_weighted_l1(spec, om):
    w = _weights_like(spec, om)
    av = torch.abs(om)
    contrib = torch.where(av == 0.0, torch.zeros_like(av), w * av)
    return spec.lam1 * _offdiag_sum(contrib)


def _scad_value_elem(av, lam, a):
    quad = (2.0 * a * lam * av - av * av - lam * lam) / (2.0 * (a - 1.0))
    tail = torch.full_like(av, 0.5 * lam * lam * (a + 1.0))
    return torch.where(av <= lam, lam * av,
                       torch.where(av <= a * lam, quad, tail))


def _value_scad(spec, om):
    return _offdiag_sum(_scad_value_elem(torch.abs(om), spec.lam1,
                                         spec.shape))


def _mcp_value_elem(av, lam, gamma):
    return torch.where(av <= gamma * lam, lam * av - av * av / (2.0 * gamma),
                       torch.full_like(av, 0.5 * gamma * lam * lam))


def _value_mcp(spec, om):
    return _offdiag_sum(_mcp_value_elem(torch.abs(om), spec.lam1, spec.shape))


# ---------------------------------------------------------------------------
# validation (factories only)
# ---------------------------------------------------------------------------

def _is_lane_batched(v) -> bool:
    """A leaf with a leading lane axis (checked per lane where used)."""
    return getattr(v, "ndim", 0) != 0


def _check_scalar(name: str, v) -> None:
    if v is None or _is_lane_batched(v):
        return
    f = float(v)
    if not math.isfinite(f) or f < 0:
        raise ValueError(f"{name} must be finite and >= 0, got {f}")


def _check_shape_param(kind: str, v, low: float) -> None:
    if v is None or _is_lane_batched(v):
        return
    f = float(v)
    if not f > low:
        raise ValueError(
            f"{kind} shape parameter must be > {low:g}, got {f!r} (the "
            f"three-regime prox needs it above the solver's max step size "
            f"tau_init = 1; nonpositive values are never valid)")


def _as_numpy(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        return w.detach().cpu().numpy()
    return np.asarray(w)


def _check_weights(w) -> None:
    if w is None:
        return
    arr = _as_numpy(w)
    if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
        raise ValueError(
            f"penalty weights must be a square (p, p) matrix, got shape "
            f"{arr.shape}")
    if np.any(np.isnan(arr)):
        raise ValueError("penalty weights must not contain NaN")
    if np.any(arr < 0):
        raise ValueError(
            f"penalty weights must be nonnegative (min was "
            f"{float(arr.min()):g}); use 0 for unpenalized entries and inf "
            f"for structural zeros")
    inf_mask = np.isinf(arr)
    if not np.array_equal(inf_mask, inf_mask.T):
        raise ValueError(
            "penalty weights must be symmetric: the inf (structural-zero) "
            "pattern differs between w and w.T")
    finite = np.where(inf_mask, 0.0, arr)
    scale = float(np.max(finite)) if finite.size else 0.0
    asym = float(np.max(np.abs(finite - finite.T))) if finite.size else 0.0
    if asym > WEIGHT_SYMMETRY_RTOL * max(scale, 1.0):
        raise ValueError(
            f"penalty weights must be symmetric: max |w - w.T| = {asym:.3e} "
            f"at scale {scale:.3e} — the estimated Omega is symmetric, so an "
            f"asymmetric penalty is almost certainly a bug (symmetrize with "
            f"(w + w.T) / 2 if the asymmetry is intended rounding)")


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class PenaltyDef(NamedTuple):
    """One penalty family: its prox, value, and construction-time checks."""
    kind: str
    prox: Callable          # (spec, z, tau) -> unmasked elementwise prox
    value: Callable         # (spec, omega)  -> nonsmooth penalty value
    validate: Callable      # (spec) -> None, raises ValueError
    kernel: bool = False    # routable through the fused prox kernel
    has_shape: bool = False
    default_shape: float | None = None


_REGISTRY: dict[str, PenaltyDef] = {}


def register_penalty(defn: PenaltyDef, *, overwrite: bool = False) -> None:
    """Register a penalty family under its kind string."""
    if not overwrite and defn.kind in _REGISTRY:
        raise ValueError(f"penalty kind {defn.kind!r} already registered")
    _REGISTRY[defn.kind] = defn


def penalty_kinds() -> list[str]:
    return sorted(_REGISTRY)


def _get_def(kind: str) -> PenaltyDef:
    try:
        return _REGISTRY[kind]
    except KeyError:
        raise ValueError(
            f"unknown penalty kind {kind!r}; available: {penalty_kinds()}"
        ) from None


def _validate_common(spec: "PenaltySpec") -> None:
    _check_scalar("lam1", spec.lam1)
    _check_scalar("lam2", spec.lam2)


def _validate_weighted(spec) -> None:
    _validate_common(spec)
    if spec.weights is None:
        raise ValueError("weighted_l1 needs a (p, p) weight matrix")
    _check_weights(spec.weights)


def _validate_scad(spec) -> None:
    _validate_common(spec)
    _check_shape_param("scad", spec.shape, 2.0)


def _validate_mcp(spec) -> None:
    _validate_common(spec)
    _check_shape_param("mcp", spec.shape, 1.0)


register_penalty(PenaltyDef("l1", _prox_l1, _value_l1, _validate_common,
                            kernel=True))
register_penalty(PenaltyDef("elastic_net", _prox_l1, _value_l1,
                            _validate_common, kernel=True))
register_penalty(PenaltyDef("weighted_l1", _prox_weighted_l1,
                            _value_weighted_l1, _validate_weighted,
                            kernel=True))
register_penalty(PenaltyDef("scad", _prox_scad, _value_scad, _validate_scad,
                            has_shape=True, default_shape=SCAD_DEFAULT_A))
register_penalty(PenaltyDef("mcp", _prox_mcp, _value_mcp, _validate_mcp,
                            has_shape=True, default_shape=MCP_DEFAULT_GAMMA))


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class PenaltySpec:
    """A penalty as data: its kind and numeric parameters.

    Construct through the validated factories (:meth:`l1`,
    :meth:`weighted_l1`, :meth:`scad`, :meth:`mcp`, :meth:`elastic_net`)
    or :func:`as_penalty`; the raw constructor skips validation.
    """
    kind: str
    lam1: Any
    lam2: Any = 0.0
    shape: Any = None       # scad ``a`` / mcp ``gamma``
    weights: Any = None     # (p, p) for weighted_l1

    # -- validated factories --------------------------------------------

    @classmethod
    def l1(cls, lam1: float, lam2: float = 0.0) -> "PenaltySpec":
        spec = cls("l1", lam1, lam2)
        _get_def("l1").validate(spec)
        return spec

    @classmethod
    def elastic_net(cls, lam1: float, lam2: float) -> "PenaltySpec":
        spec = cls("elastic_net", lam1, lam2)
        _get_def("elastic_net").validate(spec)
        return spec

    @classmethod
    def weighted_l1(cls, lam1: float, weights,
                    lam2: float = 0.0) -> "PenaltySpec":
        spec = cls("weighted_l1", lam1, lam2, weights=weights)
        _get_def("weighted_l1").validate(spec)
        return spec

    @classmethod
    def scad(cls, lam1: float, a: float = SCAD_DEFAULT_A,
             lam2: float = 0.0) -> "PenaltySpec":
        spec = cls("scad", lam1, lam2, shape=a)
        _get_def("scad").validate(spec)
        return spec

    @classmethod
    def mcp(cls, lam1: float, gamma: float = MCP_DEFAULT_GAMMA,
            lam2: float = 0.0) -> "PenaltySpec":
        spec = cls("mcp", lam1, lam2, shape=gamma)
        _get_def("mcp").validate(spec)
        return spec

    # -- unvalidated functional updates ---------------------------------

    def with_lam1(self, lam1) -> "PenaltySpec":
        """Replace the strength (a scalar or a (B,) lane vector)."""
        return dataclasses.replace(self, lam1=lam1)

    def with_weights(self, weights) -> "PenaltySpec":
        return dataclasses.replace(self, weights=weights)

    # -- solver interface -----------------------------------------------

    @property
    def kernel_ok(self) -> bool:
        """Whether the fused prox and path-step kernels implement this
        prox (the soft-threshold family: scalar or weight-matrix
        thresholds)."""
        return _get_def(self.kind).kernel

    #: the reference's name for :attr:`kernel_ok`
    pallas_ok = kernel_ok

    def prox(self, z: torch.Tensor, step, diag_mask=None) -> torch.Tensor:
        """Elementwise prox of ``step * penalty`` with the diagonal exempt.

        ``z`` is (p, p), or lane-stacked (C, p, p) with ``step`` and the
        spec's per-lane fields (C,) tensors.  ``diag_mask=None`` exempts
        the main diagonal of each matrix by copying it from ``z`` (no
        p x p identity is built); an explicit 0/1 mask is blended as
        ``out * (1 - m) + z * m``, as in the reference."""
        out = _get_def(self.kind).prox(self, z, step)
        if diag_mask is None:
            out.diagonal(dim1=-2, dim2=-1).copy_(
                z.diagonal(dim1=-2, dim2=-1))
            return out
        return out * (1.0 - diag_mask) + z * diag_mask

    def value(self, omega: torch.Tensor) -> torch.Tensor:
        """Nonsmooth penalty value h(Omega) over the off-diagonal (the
        smooth lam2 ridge lives in g, not here)."""
        return _get_def(self.kind).value(self, omega)

    # -- batching helpers -----------------------------------------------

    def leaves(self) -> list:
        """The numeric fields in the reference's ``tree_flatten`` order:
        lam1, lam2, then shape and weights where present."""
        out = [self.lam1, self.lam2]
        if self.shape is not None:
            out.append(self.shape)
        if self.weights is not None:
            out.append(self.weights)
        return out

    def replace_leaves(self, leaves) -> "PenaltySpec":
        """The spec with its numeric fields replaced, in :meth:`leaves`
        order (no validation)."""
        it = iter(leaves)
        lam1, lam2 = next(it), next(it)
        shape = next(it) if self.shape is not None else None
        weights = next(it) if self.weights is not None else None
        return PenaltySpec(self.kind, lam1, lam2, shape, weights)

    def _expected_ndims(self) -> list[int]:
        """Per-leaf base ndim in :meth:`leaves` order (scalars 0, weights
        2); a leaf with one extra leading axis of length B is a per-lane
        parameter."""
        dims = [0, 0]
        if self.shape is not None:
            dims.append(0)
        if self.weights is not None:
            dims.append(2)
        return dims

    def batch_axes(self, b: int) -> list:
        """Per leaf, in :meth:`leaves` order: 0 for a leaf carrying a
        leading (B,) lane axis, None for a leaf shared by all lanes."""
        return [
            0 if (getattr(leaf, "ndim", 0) == nd + 1
                  and leaf.shape[0] == b) else None
            for leaf, nd in zip(self.leaves(), self._expected_ndims())
        ]

    def lane(self, i: int, b: int) -> "PenaltySpec":
        """The scalar spec of lane ``i`` of a (B,)-batched spec (shared
        leaves pass through)."""
        return self.replace_leaves([
            leaf[i] if ax == 0 else leaf
            for leaf, ax in zip(self.leaves(), self.batch_axes(b))])

    # -- misc ------------------------------------------------------------

    def label(self) -> str:
        """Canonical display/parse string: 'l1', 'scad:3.7', ..."""
        if self.shape is not None and not _is_lane_batched(self.shape):
            return f"{self.kind}:{float(self.shape):g}"
        return self.kind

    def __repr__(self) -> str:        # compact, array-safe
        parts = [f"kind={self.kind!r}", f"lam1={self.lam1!r}"]
        if _is_lane_batched(self.lam2) or float(self.lam2) != 0.0:
            parts.append(f"lam2={self.lam2!r}")
        if self.shape is not None:
            parts.append(f"shape={self.shape!r}")
        if self.weights is not None:
            parts.append(f"weights=<{tuple(self.weights.shape)}>")
        return f"PenaltySpec({', '.join(parts)})"


# ---------------------------------------------------------------------------
# parsing / normalization
# ---------------------------------------------------------------------------

def parse_penalty(text: str) -> tuple[str, float | None]:
    """Parse a penalty string form: ``"l1"``, ``"scad"``, ``"scad:3.7"``,
    ``"mcp:2.5"``, ... Returns ``(kind, shape_or_None)``."""
    if not isinstance(text, str) or not text:
        raise ValueError(f"penalty string must be non-empty, got {text!r}")
    kind, sep, arg = text.partition(":")
    defn = _get_def(kind)
    if not sep:
        return kind, defn.default_shape
    if not defn.has_shape:
        raise ValueError(
            f"penalty {kind!r} takes no shape parameter (got {text!r})")
    try:
        shape = float(arg)
    except ValueError:
        raise ValueError(
            f"bad shape parameter in penalty string {text!r}: {arg!r} is "
            f"not a number") from None
    return kind, shape


def as_penalty(penalty=None, *, lam1=None, lam2=None,
               weights=None) -> PenaltySpec:
    """Normalize every accepted penalty form to a validated spec: a
    :class:`PenaltySpec` (returned as-is), a string form with the strength
    from ``lam1``/``lam2`` (``lam1`` required), a bare number (lam1 of an
    l1 penalty), or None (l1 from the kwargs)."""
    if isinstance(penalty, PenaltySpec):
        if lam1 is not None or lam2 is not None or weights is not None:
            raise ValueError(
                "a PenaltySpec already carries lam1/lam2/weights; pass "
                "either the spec or the scalar kwargs, not both")
        return penalty
    if penalty is not None and not isinstance(penalty, str):
        if lam1 is not None:
            raise ValueError("pass either a numeric penalty (= lam1) or "
                             "lam1=, not both")
        lam1, penalty = penalty, None
    if lam1 is None:
        raise TypeError(
            "the penalty strength lam1 is required alongside a penalty "
            "kind (there is no safe default)")
    lam2 = 0.0 if lam2 is None else lam2
    if penalty is None:
        if weights is not None:
            return PenaltySpec.weighted_l1(lam1, weights, lam2)
        return PenaltySpec.l1(lam1, lam2)
    kind, shape = parse_penalty(penalty)
    if kind == "weighted_l1":
        if weights is None:
            raise ValueError(
                'penalty="weighted_l1" needs the weight matrix: pass a '
                "PenaltySpec.weighted_l1(lam1, weights) instead of the "
                "string form")
        return PenaltySpec.weighted_l1(lam1, weights, lam2)
    if weights is not None:
        raise ValueError(f"penalty {kind!r} does not take weights")
    spec = PenaltySpec(kind, lam1, lam2, shape=shape)
    _get_def(kind).validate(spec)
    return spec


def normalize_penalty(penalty, lam1=None, lam2=None) -> PenaltySpec:
    """The solver-entry normalization: a spec passes through (lam1
    alongside it is an error), a string form is validated with strength
    from lam1/lam2, and the legacy floats build a raw l1 spec."""
    if penalty is None:
        if lam1 is None:
            raise TypeError("pass lam1 (or penalty=)")
        return PenaltySpec("l1", lam1, 0.0 if lam2 is None else lam2)
    if isinstance(penalty, str):
        return as_penalty(penalty, lam1=lam1, lam2=lam2)
    if lam1 is not None:
        raise ValueError(
            "a PenaltySpec already carries lam1; pass one or the other")
    return as_penalty(penalty)


def adaptive_weights(omega, eps: float = 1e-3,
                     normalize: bool = True) -> np.ndarray:
    """Stage-2 adaptive-lasso weights ``1 / (|omega_hat| + eps)`` (numpy
    in, numpy out; a tensor is brought to the host).

    ``omega_hat`` is symmetrized first (fit iterates are symmetric only to
    solver tolerance, and weight validation rightly rejects asymmetry);
    the diagonal weight is zeroed (it is unpenalized anyway).  With
    ``normalize`` the off-diagonal weights are rescaled to mean 1 so a
    stage-2 lam1 grid lives on the same scale as the stage-1 grid."""
    om = np.abs(np.asarray(_as_numpy(omega), np.float64))
    if om.ndim != 2 or om.shape[0] != om.shape[1]:
        raise ValueError(f"omega must be square (p, p), got {om.shape}")
    if not (eps > 0):
        raise ValueError(f"eps must be > 0, got {eps}")
    sym = 0.5 * (om + om.T)
    w = 1.0 / (sym + eps)
    np.fill_diagonal(w, 0.0)
    if normalize:
        n_off = om.shape[0] * (om.shape[0] - 1)
        total = float(w.sum())
        if total > 0:
            w *= n_off / total
    return w


def penalty_value(spec: PenaltySpec, omega: torch.Tensor) -> float:
    """Penalty value for fit reports, reduced on ``omega``'s device.

    The l1 family accumulates in the estimate's own dtype; the other
    kinds in float64 (the reference's host-side reporting rule)."""
    if spec.kind in ("l1", "elastic_net"):
        return float(spec.lam1) * float(offdiag_l1(omega))
    return float(spec.value(omega.to(torch.float64)))
