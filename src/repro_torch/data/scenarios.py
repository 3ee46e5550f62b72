"""Scenario generators: (Ω_true, seeded chunked sampler) pairs for ≥5
graph families, with controlled condition number.

Port of ``repro.data.scenarios``:

  family          structure
  ``banded``      k-banded precision (chain is band=1): local dependence
  ``hub``         star groups — a few high-degree hub variables
  ``erdos_renyi`` homogeneous random graph, expected degree controlled
  ``block``       block-diagonal communities, dense within, none across
  ``scale_free``  Barabási–Albert preferential attachment (power-law
                  degrees — the hard case for uniform-penalty recovery)

Every family builds a symmetric off-diagonal weight pattern A (numpy,
from ``default_rng((crc32(family), seed))``, exactly as the reference
draws it) and then sets the diagonal ANALYTICALLY for an exact target
condition number: Ω = (A + δI)/δ with δ = (λmax(A) − κ·λmin(A))/(κ − 1),
which makes cond(Ω) = κ and diag(Ω) = 1 (support of A untouched).

The O(p³) and O(m p²) linear algebra runs on the scenario's device: the
eigenvalues of A, the Cholesky factor Ω = L Lᵀ and each chunk's
triangular solve Xᵀ = L⁻ᵀ Zᵀ (rows of covariance Ω⁻¹).  Every random
draw stays numpy, chunk i from
``default_rng((family_hash, seed, sample_seed, i))`` in the reference's
order, so the port streams the reference's X (to solver rounding) — one
chunk at a time, as tensors on the device, without ever holding X.
``heavy_tail_df`` switches the marginals to a multivariate-t-style scale
mixture (same precision structure, heavier tails).
"""
from __future__ import annotations

import zlib
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .shards import CallableSource

__all__ = [
    "SCENARIO_FAMILIES", "Scenario", "available_families", "make_scenario",
    "register_family",
]

DEFAULT_COND = 10.0


# ---------------------------------------------------------------------------
# off-diagonal weight patterns (symmetric, zero diagonal; numpy draws)
# ---------------------------------------------------------------------------

def _banded_weights(p: int, rng, *, band: int = 2, weight: float = 0.4,
                    decay: float = 0.5) -> np.ndarray:
    a = np.zeros((p, p))
    for k in range(1, min(band, p - 1) + 1):
        w = weight * decay ** (k - 1)
        idx = np.arange(p - k)
        a[idx, idx + k] = w
        a[idx + k, idx] = w
    return a


def _hub_weights(p: int, rng, *, group: int = 16,
                 weight: float = 0.35) -> np.ndarray:
    a = np.zeros((p, p))
    for lo in range(0, p, group):
        hub = lo
        for v in range(lo + 1, min(lo + group, p)):
            w = weight * rng.uniform(0.6, 1.0)
            a[hub, v] = a[v, hub] = w
    return a


def _erdos_renyi_weights(p: int, rng, *, avg_degree: float = 4.0,
                         weight: float = 0.3) -> np.ndarray:
    prob = min(1.0, avg_degree / max(p - 1, 1))
    upper = np.triu(rng.random((p, p)) < prob, k=1)
    signs = rng.choice([-1.0, 1.0], size=(p, p))
    mags = rng.uniform(0.5, 1.0, size=(p, p)) * weight
    w = np.where(upper, signs * mags, 0.0)
    return w + w.T


def _block_weights(p: int, rng, *, block: int = 8,
                   weight: float = 0.3) -> np.ndarray:
    a = np.zeros((p, p))
    for lo in range(0, p, block):
        hi = min(lo + block, p)
        b = hi - lo
        signs = rng.choice([-1.0, 1.0], size=(b, b))
        mags = rng.uniform(0.5, 1.0, size=(b, b)) * weight
        w = np.triu(signs * mags, k=1)
        a[lo:hi, lo:hi] = w + w.T
    return a


def _scale_free_weights(p: int, rng, *, m: int = 2,
                        weight: float = 0.3) -> np.ndarray:
    """Barabási–Albert preferential attachment: each arriving node links
    to ``m`` existing nodes with probability proportional to degree."""
    a = np.zeros((p, p))
    m = max(1, min(m, p - 1))
    repeated: list[int] = list(range(m))      # degree-weighted urn
    for v in range(m, p):
        chosen: set[int] = set()
        while len(chosen) < min(m, v):
            if repeated:
                pick = repeated[int(rng.integers(len(repeated)))]
            else:
                pick = int(rng.integers(v))
            if pick != v:
                chosen.add(pick)
        for t in chosen:
            w = weight * rng.uniform(0.5, 1.0) * rng.choice([-1.0, 1.0])
            a[v, t] = a[t, v] = w
            repeated.extend([v, t])
    return a


SCENARIO_FAMILIES: dict[str, Callable] = {}


def register_family(name: str, builder: Callable, *,
                    overwrite: bool = False) -> None:
    """Plug in a new family: ``builder(p, rng, **kw) -> (p, p) symmetric
    zero-diagonal weights`` (numpy)."""
    if not overwrite and name in SCENARIO_FAMILIES:
        raise ValueError(f"family {name!r} already registered")
    SCENARIO_FAMILIES[name] = builder


def available_families() -> list[str]:
    return sorted(SCENARIO_FAMILIES)


register_family("banded", _banded_weights)
register_family("hub", _hub_weights)
register_family("erdos_renyi", _erdos_renyi_weights)
register_family("block", _block_weights)
register_family("scale_free", _scale_free_weights)


# ---------------------------------------------------------------------------
# conditioning + the Scenario object
# ---------------------------------------------------------------------------

def _condition(a: torch.Tensor, cond: float) -> tuple[torch.Tensor, float]:
    """Ω = (A + δI)/δ with δ solving (λmax+δ)/(λmin+δ) = cond exactly,
    on A's device.  Returns (Ω, achieved cond).  diag(Ω) = 1;
    support(Ω) = support(A)."""
    if cond <= 1.0:
        raise ValueError(f"cond must be > 1, got {cond}")
    ev = torch.linalg.eigvalsh(a)
    lmin, lmax = float(ev[0]), float(ev[-1])
    del ev
    if lmax - lmin < 1e-12:                     # empty graph -> identity
        omega = torch.zeros_like(a)
        omega.diagonal().fill_(1.0)
        return omega, 1.0
    delta = (lmax - cond * lmin) / (cond - 1.0)
    omega = a.clone()
    omega.diagonal().add_(delta)
    return omega.div_(delta), (lmax + delta) / (lmin + delta)


class Scenario(NamedTuple):
    """(Ω_true, sampler) pair: the ground truth and a way to stream X."""
    name: str               # family name
    p: int
    omega: torch.Tensor     # (p, p) f64 true precision on device, diag = 1
    cond: float             # achieved condition number (== requested)
    seed: int               # graph-structure seed
    heavy_tail_df: float | None = None   # None -> Gaussian marginals

    @property
    def device(self) -> torch.device:
        return self.omega.device

    @property
    def avg_degree(self) -> float:
        off = int((self.omega.abs() > 1e-12).sum())
        return float((off - self.p) / self.p)

    def _chunks(self, n: int, chunk_rows: int, seed: int):
        chol = torch.linalg.cholesky(self.omega)    # Ω = L Lᵀ
        tag = zlib.crc32(self.name.encode()) & 0x7FFFFFFF
        i = 0
        for lo in range(0, n, chunk_rows):
            m = min(chunk_rows, n - lo)
            rng = np.random.default_rng((tag, self.seed, seed, i))
            z = torch.from_numpy(rng.standard_normal((m, self.p)))
            # Xᵀ = L⁻ᵀ Zᵀ (cov Ω⁻¹), as X L = Z by substitution on the
            # device: O(m p^2); rows made contiguous, as the reference's
            # chunks are (the solve returns them column-major)
            x = torch.linalg.solve_triangular(
                chol, z.to(self.device), upper=False, left=False)
            del z
            x = x.contiguous()
            if self.heavy_tail_df is not None:
                chi = rng.chisquare(self.heavy_tail_df,
                                    size=(m, 1)) / self.heavy_tail_df
                x.div_(torch.from_numpy(np.sqrt(chi)).to(self.device))
            yield x
            i += 1

    def source(self, n: int, *, chunk_rows: int = 4096,
               seed: int = 0) -> CallableSource:
        """Re-iterable chunk source for n rows (float64 tensors on the
        scenario's device) — the stream identity is (family, structure
        seed, sample seed, chunk_rows); re-iterating reproduces the same
        stream, chunk by chunk, without ever holding X."""
        return CallableSource(
            lambda: self._chunks(n, chunk_rows, seed),
            p=self.p, n_rows=n)

    def sample(self, n: int, *, seed: int = 0,
               chunk_rows: int = 4096) -> torch.Tensor:
        """Materialized (n, p) sample — small-n tests and baselines only."""
        return torch.cat(list(self._chunks(n, chunk_rows, seed)))


def make_scenario(family: str, p: int, *, seed: int = 0,
                  cond: float = DEFAULT_COND,
                  heavy_tail_df: float | None = None, device=None,
                  **family_kw) -> Scenario:
    """Build one scenario: family weights -> exact-cond Ω -> sampler, on
    ``device`` (``None``: the CUDA card, raising without one)."""
    try:
        builder = SCENARIO_FAMILIES[family]
    except KeyError:
        raise ValueError(
            f"unknown scenario family {family!r}; available: "
            f"{available_families()}") from None
    dev = resolve_device(device)
    rng = np.random.default_rng((zlib.crc32(family.encode()), seed))
    a = torch.as_tensor(
        np.asarray(builder(int(p), rng, **family_kw), np.float64),
        device=dev)
    if tuple(a.shape) != (p, p) or float((a - a.T).abs().max()) > 1e-12 \
            or float(a.diagonal().abs().max()) > 1e-12:
        raise ValueError(
            f"family {family!r} produced an invalid weight pattern")
    omega, achieved = _condition(a, cond)
    return Scenario(name=family, p=int(p), omega=omega,
                    cond=float(achieved), seed=int(seed),
                    heavy_tail_df=heavy_tail_df)
