"""Analytic cost model for HP-CONCORD (paper Lemmas 3.1-3.5) + auto-tuner.

A copy of the parts of ``repro.core.costmodel`` that the single-device
slice decides with: the variant tuner behind ``variant="auto"`` and the
dense <-> block-sparse crossover behind ``sparse_matmul="auto"``.

    T = F*gamma + L*alpha + W*beta

with machine constants gamma (s/flop), alpha (s/message), beta (s/word).
The port's default machine is :data:`H100`, whose constants are NVIDIA's
data-sheet figures for one H100 SXM card.  They are NOT measured on this
system; a calibration run (``benchmarks/sparse_crossover.py`` once it is
ported) replaces them.  The reference's TPU constants play no part in the
port's decisions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable


@dataclass(frozen=True)
class Machine:
    """Machine-dependent constants (per device).  The defaults are the
    H100 SXM data sheet, not a measurement."""
    name: str = "h100_sxm"
    peak_flops: float = 67e12         # FLOP/s, float64 tensor cores
    hbm_bw: float = 3.35e12           # bytes/s, HBM3
    link_bw: float = 450e9            # bytes/s, NVLink each way
    msg_overhead: float = 1e-5        # s per collective round (assumed)
    hbm_bytes: float = 80e9           # device memory
    word_bytes: int = 8               # float64 words for Omega/S/X

    @property
    def gamma(self) -> float:
        return 1.0 / self.peak_flops

    @property
    def beta(self) -> float:
        return self.word_bytes / self.link_bw

    @property
    def alpha(self) -> float:
        return self.msg_overhead


#: one H100 SXM card, data-sheet constants (not measured)
H100 = Machine()


@dataclass(frozen=True)
class ProblemShape:
    p: int                  # dimensions
    n: int                  # samples
    d: float                # avg nnz per row of Omega across iterations
    s: int = 30             # proximal-gradient iterations
    t: float = 10.0         # avg line-search trials per outer iteration


@dataclass
class CostBreakdown:
    variant: str
    c_x: int
    c_omega: int
    flops: float
    messages: float
    words: float
    mem_words: float
    t_compute: float = 0.0
    t_latency: float = 0.0
    t_bandwidth: float = 0.0

    @property
    def total(self) -> float:
        return self.t_compute + self.t_latency + self.t_bandwidth


def _q(P: int, c_x: int, c_omega: int) -> float:
    return max(P / c_x**2, P / c_omega**2)


def cov_costs(shape: ProblemShape, P: int, c_x: int, c_omega: int,
              m: Machine) -> CostBreakdown:
    """Lemma 3.4/3.5 (Cov): F, L, W and T for given replication factors."""
    p, n, d, s, t = shape.p, shape.n, shape.d, shape.s, shape.t
    Q = _q(P, c_x, c_omega)
    lg = math.log2(max(Q, 2))
    F = 2 * n * p**2 + 2 * d * p**2 * (s * t + 1)
    L = P / c_x**2 + s * t * P / (c_x * c_omega) + lg
    W = n * p / c_x + s * t * d * p / c_x + p**2 * (c_x * c_omega / P) * Q * lg
    M = c_omega * d * p + 3 * c_x * p**2
    cb = CostBreakdown("cov", c_x, c_omega, F, L, W, M)
    cb.t_compute = F / P * m.gamma
    cb.t_latency = L * m.alpha
    cb.t_bandwidth = W * m.beta
    return cb


def obs_costs(shape: ProblemShape, P: int, c_x: int, c_omega: int,
              m: Machine) -> CostBreakdown:
    """Lemma 3.4/3.5 (Obs)."""
    p, n, d, s, t = shape.p, shape.n, shape.d, shape.s, shape.t
    Q = _q(P, c_x, c_omega)
    lg = math.log2(max(Q, 2))
    F = 2 * n * p**2 * s + 2 * d * n * p * (s * t + 1)
    L = s * (t + 1) * P / (c_omega * c_x) + lg
    W = s * (t + 1) * n * p / c_omega + p**2 * (c_x * c_omega / P) * Q * lg
    M = 2 * c_x * n * p + c_omega * (d * p + n * p + 2 * p**2)
    cb = CostBreakdown("obs", c_x, c_omega, F, L, W, M)
    cb.t_compute = F / P * m.gamma
    cb.t_latency = L * m.alpha
    cb.t_bandwidth = W * m.beta
    return cb


def _divisors(P: int) -> list[int]:
    return [c for c in range(1, P + 1) if P % c == 0]


def enumerate_configs(shape: ProblemShape, P: int, m: Machine,
                      variants: Iterable[str] = ("cov", "obs")
                      ) -> list[CostBreakdown]:
    """All feasible (variant, c_x, c_omega) under replication & memory caps."""
    out = []
    mem_cap_words = m.hbm_bytes / m.word_bytes * P
    for c_x in _divisors(P):
        for c_omega in _divisors(P):
            if c_x * c_omega > P:
                continue
            for v in variants:
                fn = cov_costs if v == "cov" else obs_costs
                cb = fn(shape, P, c_x, c_omega, m)
                if cb.mem_words <= mem_cap_words:
                    out.append(cb)
    return out


def tune(shape: ProblemShape, P: int, m: Machine | None = None,
         variants: Iterable[str] = ("cov", "obs")) -> CostBreakdown:
    """Pick the best (variant, c_x, c_omega) for the problem."""
    m = m or H100
    configs = enumerate_configs(shape, P, m, variants)
    if not configs:
        raise ValueError(
            f"no feasible replication config for p={shape.p} on P={P} "
            f"(need more devices: min aggregate memory ~{3*shape.p**2} "
            f"words)")
    return min(configs, key=lambda cb: cb.total)


# ---------------------------------------------------------------------------
# dense vs block-sparse matmul crossover (the matops layer's cost model)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BlockSparseModel:
    """Constants of the dense <-> block-sparse crossover for the Omega-side
    product C = A(p,p) @ B(p,m) with A at block density delta:

      T_dense(p, m)      = 2 p^2 m gamma / dense_eff
      T_sparse(p, m, d)  = 2 d p^2 m gamma / sparse_eff
                         + d nb (2 bs m + bs^2) w / B / gather_eff

    The efficiencies are the reference's conservative defaults; they are
    not measured on the H100."""
    dense_eff: float = 0.85
    sparse_eff: float = 0.45
    gather_eff: float = 0.50


def _nb_total(p: int, block_size: int) -> int:
    return (-(-p // block_size)) ** 2


def dense_matmul_time(p: int, m: int, machine: Machine | None = None,
                      model: BlockSparseModel | None = None) -> float:
    machine = machine or H100
    model = model or BlockSparseModel()
    return 2.0 * p * p * m * machine.gamma / model.dense_eff


def blocksparse_matmul_time(p: int, m: int, density: float, block_size: int,
                            machine: Machine | None = None,
                            model: BlockSparseModel | None = None) -> float:
    machine = machine or H100
    model = model or BlockSparseModel()
    bs = block_size
    flops = 2.0 * density * p * p * m * machine.gamma / model.sparse_eff
    gathered_bytes = (density * _nb_total(p, bs) * (2.0 * bs * m + bs * bs)
                      * machine.word_bytes)
    return flops + gathered_bytes / machine.hbm_bw / model.gather_eff


def crossover_density(p: int, m: int, block_size: int,
                      machine: Machine | None = None,
                      model: BlockSparseModel | None = None) -> float:
    """Block density at which T_sparse = T_dense — the routing threshold
    of ``sparse_matmul="auto"``, clamped to [0, 1]."""
    td = dense_matmul_time(p, m, machine, model)
    ts1 = blocksparse_matmul_time(p, m, 1.0, block_size, machine, model)
    if ts1 <= 0.0:
        return 1.0
    return max(0.0, min(1.0, td / ts1))
