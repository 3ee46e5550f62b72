"""Carry problems, penalties and configs into the port from plain data.

The port never imports the JAX package, so these helpers are duck-typed
on numpy arrays, floats and dicts: a caller holding a ``repro`` object
unpacks it (``dataclasses.asdict(config)``, ``np.asarray(omega)``, the
spec's fields) and hands the plain values over.  The parity tests use
them to give both packages the same problem, penalty, warm start and
configuration.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.penalty import PenaltySpec, _get_def
from .device import resolve_device
from .estimator.config import SolverConfig


def penalty_from_numpy(kind: str, lam1, lam2=0.0, shape=None,
                       weights=None) -> PenaltySpec:
    """A validated :class:`PenaltySpec` from plain values (numpy scalars
    or arrays are accepted; ``weights`` stays a float64 numpy matrix
    until a solve moves it to its device)."""
    spec = PenaltySpec(
        kind, float(np.asarray(lam1)), float(np.asarray(lam2)),
        shape=None if shape is None else float(np.asarray(shape)),
        weights=None if weights is None else np.array(weights, np.float64))
    _get_def(kind).validate(spec)
    return spec


def config_from_mapping(mapping, **overrides) -> SolverConfig:
    """A :class:`SolverConfig` from a dict of field values (e.g.
    ``dataclasses.asdict`` of the reference's config).  Keys the port
    does not know raise ``ValueError``; ``overrides`` win (e.g.
    ``device="cpu"``)."""
    known = {f.name for f in dataclasses.fields(SolverConfig)}
    fields = dict(mapping)
    fields.update(overrides)
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown SolverConfig field(s): {unknown}")
    return SolverConfig(**fields)


def omega_from_numpy(arr, device=None,
                     dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """A warm start (or any matrix) as a tensor on ``device``."""
    return torch.as_tensor(np.asarray(arr), dtype=dtype,
                           device=resolve_device(device))
