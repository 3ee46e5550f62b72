"""Analytic cost model for HP-CONCORD (paper Lemmas 3.1-3.5) + auto-tuner.

A copy of the parts of ``repro.core.costmodel`` that the port decides
with: the variant tuner behind ``variant="auto"``, the dense <->
block-sparse crossover behind ``sparse_matmul="auto"`` and its
calibration from measured rows (``calibrate_block_model``), the streaming
Gram's chunk-size guidance (``gram_chunk_rows``), the batched path
engine's difficulty model and ``fit_path(mode="auto")`` decision, and
the exact communication volume of the 1.5D products (``comm_volume``).

    T = F*gamma + L*alpha + W*beta

with machine constants gamma (s/flop), alpha (s/message), beta (s/word).
The port's default machine is :data:`H100`, whose constants are NVIDIA's
data-sheet figures for one H100 SXM card, not measurements;
:data:`EDISON` is the paper's machine with the reference's constants,
for pricing the paper's own figures.  The
reference's TPU constants play no part in the port's decisions.  The
path-scheduling constants (trials per iteration, the iteration power law,
the gemm step-cost and pilot factors) are the reference's, copied
unchanged so both packages schedule a grid alike; they are ratios the
reference measured for itself on a CPU host, not measurements of the
port.  Two sets of constants are measured on the H100 and decide on a
CUDA device: :data:`CARD_STEP_COST`, the step costs with which
``fit_path(mode="auto")`` picks a mode, and :data:`CARD_BLOCK_MODEL`, the
dense <-> block-sparse crossover fitted from ``chip_smoke.py`` phase
``calibrate``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
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

#: the paper's machine, NERSC Edison (Cray XC30), per node, as the
#: reference prices it: the paper's constants, not a card measurement
EDISON = Machine(
    name="edison_xc30",
    peak_flops=460.8e9,     # 2x12 cores x 2.4GHz x 8 flops (per node)
    hbm_bw=100e9,
    link_bw=8e9,            # Aries per-direction
    msg_overhead=2e-6,
    hbm_bytes=64e9,
    word_bytes=8,           # paper ran double precision
)


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


def cov_is_cheaper(shape: ProblemShape) -> bool:
    """Lemma 3.1 crossover: Cov wins iff d/p < (n/(p-n)) * (1/t)."""
    p, n, d, t = shape.p, shape.n, shape.d, shape.t
    if n >= p:
        return True
    return (d / p) < (n / (p - n)) / t


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

    The defaults are the reference's conservative efficiencies, not
    measured on the H100; :data:`CARD_BLOCK_MODEL` is."""
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


def calibrate_block_model(rows, machine: Machine | None = None
                          ) -> BlockSparseModel:
    """Refit :class:`BlockSparseModel` from measured sweep rows (dicts with
    ``p``, ``m``, ``block_size``, ``density``, ``t_dense``, ``t_sparse``),
    as ``repro.core.costmodel.calibrate_block_model`` fits them: the
    median dense efficiency, then a least-squares fit of the two sparse
    coefficients.  ``chip_smoke.py`` phase ``calibrate`` makes the rows
    on the card."""
    import numpy as np

    machine = machine or H100
    rows = [r for r in rows if r.get("t_dense", 0) > 0 and
            r.get("t_sparse", 0) > 0]
    if not rows:
        raise ValueError("no usable rows to calibrate from")
    dense_effs = [2.0 * r["p"] ** 2 * r["m"] * machine.gamma / r["t_dense"]
                  for r in rows]
    dense_eff = float(np.median(dense_effs))
    # least squares for the two sparse-path coefficients
    a = np.array([[2.0 * r["density"] * r["p"] ** 2 * r["m"] * machine.gamma,
                   r["density"] * _nb_total(r["p"], r["block_size"])
                   * (2.0 * r["block_size"] * r["m"] + r["block_size"] ** 2)
                   * machine.word_bytes / machine.hbm_bw]
                  for r in rows])
    y = np.array([r["t_sparse"] for r in rows])
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)
    inv_sparse_eff = max(float(coef[0]), 1e-12)
    inv_gather_eff = max(float(coef[1]), 1e-12)
    return BlockSparseModel(dense_eff=max(dense_eff, 1e-12),
                            sparse_eff=1.0 / inv_sparse_eff,
                            gather_eff=1.0 / inv_gather_eff)


#: the crossover's constants measured on the H100 (NVIDIA H100 80GB HBM3,
#: 700.00 W): ``calibrate_block_model`` over :data:`H100` of ``chip_smoke.py``
#: phase ``calibrate``'s rows (p = 16384, block 128, m = 16384 and 1200,
#: block densities 1/128 to 1; PERF.md section 6).  The fit's
#: flop coefficient came out negative and is clamped (``sparse_eff``
#: 1e12), so kernel 2 is priced by its gathered bytes alone: crossovers
#: 0.520 at m = 16384 and 0.496 at m = 1200, where the rows cross near
#: 0.70 and 0.68.  ``sparse_matmul="auto"`` routes with it when the
#: solve's device is CUDA and with the data-sheet
#: :class:`BlockSparseModel` on the CPU.
CARD_BLOCK_MODEL = BlockSparseModel(dense_eff=0.8349614649979095,
                                    sparse_eff=1e12,
                                    gather_eff=0.544698968616549)


def gram_chunk_rows(p: int, *, machine: Machine | None = None,
                    budget_bytes: float | None = None,
                    dtype_bytes: int = 8) -> int:
    """Chunk-size guidance for the streaming Gram pipeline (``data.gram``),
    as ``repro.core.costmodel.gram_chunk_rows`` computes it:

      * memory — the f64 chunk (m·p·8 B) and one transform copy of it
        must fit what the budget leaves after the (p, p) f64 accumulator
        (default budget: 1/8 of the machine's device memory, leaving room
        for the solve that follows; 10 GB on :data:`H100`, so p = 16384
        gives 29,954 rows);
      * efficiency — floor at 256 rows (below a few hundred rows the
        panel product turns bandwidth-bound), cap at 2^20.

    Raises when the (p, p) accumulator alone exhausts the budget: no
    chunk size helps then, and the Gram must be sharded across devices
    (``data.distributed_gram``, a later slice) or given a bigger budget.
    """
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    machine = machine or H100
    budget = budget_bytes if budget_bytes is not None \
        else machine.hbm_bytes / 8.0
    left = budget - float(p) * p * dtype_bytes
    if left <= 0:
        raise ValueError(
            f"the (p, p) f64 accumulator alone ({p}^2 x {dtype_bytes} B = "
            f"{p * p * dtype_bytes / 1e9:.1f} GB) exceeds the "
            f"{budget / 1e9:.1f} GB budget; shard the Gram across devices "
            f"(data.distributed_gram) or raise budget_bytes")
    rows = int(left // (2 * p * dtype_bytes))
    return max(256, min(rows, 1 << 20))


# ---------------------------------------------------------------------------
# batched-vs-sequential path scheduling (the core.batch compact engine's
# difficulty model and fit_path(mode="auto")'s decision procedure)
# ---------------------------------------------------------------------------

#: measured average line-search trials per outer iteration for each
#: tau schedule (BENCH_path_batch shapes, identity cold start): "restart"
#: re-rejects from tau_init every iteration, "greedy" grows the accepted
#: tau by 1.3x and almost always accepts first try
TAU_TRIALS_PER_ITER = {"restart": 2.3, "warm": 1.7, "greedy": 1.35}


@dataclass(frozen=True)
class PathIterModel:
    """Power-law iteration predictor for a cold-started proximal-gradient
    solve at penalty strength lam1:

        iters(lam1) ~= base_iters * lam1 ** -exponent

    Smaller lam1 means a denser estimate and a flatter objective, so
    iteration counts grow as the penalty shrinks.  The constants are fit
    to the BENCH_path_batch chain-scenario paths (p = 128..512,
    tol = 1e-6); only the ORDERING and the rough totals matter — the
    compact engine uses this to schedule lanes hardest-first and
    ``choose_path_mode`` to pick an execution mode, neither of which
    needs per-problem accuracy."""
    base_iters: float = 11.0     # iters at lam1 = 1
    exponent: float = 1.0


def predict_path_iters(lam1, *, model: PathIterModel | None = None,
                       max_iters: int = 500):
    """Predicted outer-iteration counts for a lam1 grid (elementwise,
    clipped to [1, max_iters]).  Monotone decreasing in lam1, so sorting
    by the prediction is sorting hardest-first."""
    import numpy as np

    model = model or PathIterModel()
    lam1 = np.asarray(lam1, np.float64)
    pred = model.base_iters * np.power(np.maximum(lam1, 1e-12),
                                       -model.exponent)
    return np.clip(pred, 1.0, float(max(max_iters, 1)))


#: measured per-lane-step wall-clock of the compact engine's gemm routes
#: relative to the sequential XLA baseline on a one-core CPU host
#: (BENCH_path_batch, p = 512 f64: host BLAS stepper ~10 ms/lane-step vs
#: ~14.5 ms through XLA)
GEMM_STEP_COST = {"xla": 1.0, "host": 0.70}

#: the same ratio measured on the H100 (NVIDIA H100 80GB HBM3, 700 W;
#: ``chip_smoke.py`` phase ``pathmode``, p = 16384, PERF.md section 5:
#: 168.3 ms per batched lane trial with the pilot, 22.34 ms per
#: sequential trial through kernel 2, 174.8 ms per dense one):
#: one lane trial of the batched engine over one sequential trial, by
#: the sequential product route.  The batched engine multiplies every
#: lane densely (the reference's design), while a sequential trial with
#: a block-sparse policy routes W = Omega S through kernel 2 once the
#: iterate is sparse ("blocksparse"); without one it is dense too
#: ("dense").  ``fit_path(mode="auto")`` on a CUDA device prices the
#: modes with this class, never with the CPU-host ratios above.
CARD_STEP_COST = {"dense": 0.963, "blocksparse": 7.533}

#: measured flat-step reduction of warm_start="pilot" on the non-pilot
#: lanes (cold 202 -> pilot-warmed 141 total ls trials on the
#: BENCH_path_batch 8-point grid; the pilot lane itself runs cold)
PILOT_WARM_FACTOR = 0.70


def _ladder_tier(n: int) -> int:
    cap = 1
    while cap < n:
        cap = 3 * cap // 2 if cap % 2 == 0 and 3 * cap // 2 >= n \
            else cap * 2
    return cap


def _padded_compact_cost(steps, chunk: int) -> int:
    """Padded lane-steps of the compact schedule: each segment of
    ``chunk`` steps pays the capacity tier of its live-lane count, and
    lanes only leave at segment boundaries."""
    import numpy as np

    remaining = np.sort(np.asarray(steps, np.int64))[::-1].copy()
    padded = 0
    while remaining.size:
        tier = _ladder_tier(int(remaining.size))
        dt = min(int(chunk), int(remaining.max()))
        padded += tier * dt
        remaining = remaining - dt
        remaining = remaining[remaining > 0]
    return padded


def predict_batched_speedup(lam1_grid, *, tau_schedule: str = "restart",
                            chunk: int = 32, max_iters: int = 500,
                            gemm: str = "xla",
                            warm_start: str | None = None,
                            model: PathIterModel | None = None,
                            step_cost: float | None = None) -> float:
    """Predicted wall-clock ratio sequential/compact-batched for a lam1
    path on throughput-limited hardware (one device, cost proportional to
    lane-steps executed).

    Simulates the compact engine's segmented schedule on the predicted
    per-lane flat-step counts (see :func:`_padded_compact_cost`), then
    applies the engine's per-step cost factor (``gemm``,
    :data:`GEMM_STEP_COST`) and the pilot warm-start step reduction
    (``warm_start="pilot"``, :data:`PILOT_WARM_FACTOR`).  The sequential
    baseline is the shipped default: cold XLA solves, plain sum of
    per-lane steps.  >1 means batching is predicted to win; the
    estimator's ``fit_path(mode="auto")`` thresholds this.  ``step_cost``
    (a :data:`CARD_STEP_COST` entry) replaces the ``gemm`` class's
    factor."""
    import numpy as np

    trials = TAU_TRIALS_PER_ITER.get(tau_schedule,
                                     TAU_TRIALS_PER_ITER["restart"])
    iters = predict_path_iters(lam1_grid, model=model, max_iters=max_iters)
    steps = np.maximum(np.rint(iters * trials), 1.0).astype(np.int64)
    seq = int(steps.sum())
    if step_cost is None:
        step_cost = GEMM_STEP_COST.get(gemm, 1.0)
    if warm_start == "pilot" and steps.size > 1:
        # the median-difficulty pilot runs cold and alone; every other
        # lane starts from its solution and converges in fewer steps
        order = np.argsort(steps)
        pilot = order[len(order) // 2]
        rest = np.delete(steps, pilot)
        rest = np.maximum(np.rint(rest * PILOT_WARM_FACTOR), 1.0)
        padded = int(steps[pilot]) + _padded_compact_cost(rest, chunk)
    else:
        padded = _padded_compact_cost(steps, chunk)
    return seq / (padded * step_cost) if padded else 1.0


def choose_path_mode(lam1_grid, *, tau_schedule: str = "restart",
                     chunk: int = 32, max_iters: int = 500,
                     gemm: str = "xla", warm_start: str | None = None,
                     threshold: float = 1.05,
                     step_cost: float | None = None) -> str:
    """The ``fit_path(mode="auto")`` decision: "batched" when the
    compact engine's predicted speedup clears ``threshold`` (a short or
    uniformly-hard grid has too little compaction headroom to pay the
    batched program's padding), else "sequential"."""
    import numpy as np

    grid = np.asarray(lam1_grid, np.float64)
    if grid.size <= 1:
        return "sequential"
    speedup = predict_batched_speedup(
        grid, tau_schedule=tau_schedule, chunk=chunk, max_iters=max_iters,
        gemm=gemm, warm_start=warm_start, step_cost=step_cost)
    return "batched" if speedup >= threshold else "sequential"


# ---------------------------------------------------------------------------
# exact communication-volume accounting
# ---------------------------------------------------------------------------
# Where Lemmas 3.4/3.5 above model asymptotic words moved as float cost
# terms, this layer is EXACT: per-processor bytes-on-wire along the
# critical path of one invocation, as `fractions.Fraction`s, so the bytes
# that ``comm.group``'s wrappers announce while a product runs can be
# held equal to these formulas with == instead of a tolerance.
#
# Conventions (one per collective primitive, extent E = product of the
# bound grid-axis sizes):
#   ppermute      payload bytes once — ZERO if the permutation table is
#                 the identity (no pair moves)
#   psum/pmin/..  bandwidth-optimal all-reduce: 2 (E-1)/E * payload
#   all_gather    ring gather: (E-1) * payload(input shard)
#   all_to_all / reduce_scatter / psum_scatter: (E-1)/E * payload
# E <= 1 is always zero bytes.

#: wire width of the dtypes the schedules ship
DTYPE_BYTES = {
    "float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
    "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1,
    "bool": 1,
}

_REDUCE_PRIMS = frozenset({"psum", "pmin", "pmax", "psum_invariant"})
_GATHER_PRIMS = frozenset({"all_gather", "all_gather_invariant"})
_SCATTER_PRIMS = frozenset({"all_to_all", "reduce_scatter", "psum_scatter"})


def collective_wire_bytes(prim: str, payload_bytes, extent,
                          *, moves: bool = True) -> Fraction:
    """Per-processor critical-path bytes of ONE collective invocation."""
    b = Fraction(payload_bytes)
    if extent is None or extent <= 1:
        return Fraction(0)
    if prim in ("ppermute", "pbroadcast"):
        return b if moves else Fraction(0)
    if prim in _REDUCE_PRIMS:
        return Fraction(2 * (extent - 1), extent) * b
    if prim in _GATHER_PRIMS:
        return (extent - 1) * b
    if prim in _SCATTER_PRIMS:
        return Fraction(extent - 1, extent) * b
    raise ValueError(f"no wire-byte convention for primitive {prim!r}")


@dataclass(frozen=True)
class CommVolume:
    """Exact per-processor bytes of one 1.5D product invocation."""
    flavor: str
    rounds: int              # ring length (Alg. 4 rotation rounds)
    ring_bytes: Fraction     # stagger + per-round shift ppermutes
    finish_bytes: Fraction   # team all_gather (gather) / psum (reduce)

    @property
    def total(self) -> Fraction:
        return self.ring_bytes + self.finish_bytes


def _perm_moves(perm) -> int:
    """1 if the ppermute actually puts bytes on a wire, else 0."""
    return int(any(s != d for s, d in perm))


def comm_volume(p: int, n: int, n_devices: int, c_x: int, c_omega: int, *,
                flavor: str, dtype: str = "float64",
                canonical: str | None = None, masked: bool = False,
                block_size: int | None = None) -> CommVolume:
    """Exact bytes-on-wire of one 1.5D matmul (paper Algorithm 4).

    ``flavor`` is one of the four ring products of ``comm.matmul1p5d``:

      * ``"xtx"``      gather flavor, S = X^T X        (Cov line 2)
      * ``"omega_s"``  gather flavor, W = Omega S      (Cov; ``canonical``
                       "omegalike" standalone / "xlike" inside the driver;
                       ``masked`` adds the rotating int8 occupancy mask)
      * ``"y_x"``      gather flavor, Z = Y X          (Obs line 4)
      * ``"omega_xt"`` reduce flavor, Y = Omega X^T    (Obs lines 2/10;
                       ``masked`` adds NOTHING — the mask is fixed and
                       sliced locally, it never rides the ring)

    Stagger/shift movement is decided by constructing the very same
    permutation tables the schedule uses (``comm.grid.Grid1p5D``) and
    asking whether any pair moves: the closed-form identity conditions
    are full of corner cases (e.g. the xtx stagger IS the identity at
    c_x = P even though c_x > 1).
    """
    from ..comm.grid import Grid1p5D  # lazy: core stays importable alone

    g = Grid1p5D(n_devices, c_x, c_omega)
    w = DTYPE_BYTES[dtype]
    n_x, n_om = g.n_x, g.n_om
    blk_x, blk_om = p // n_x, p // n_om
    if masked and flavor in ("xtx", "y_x"):
        raise ValueError(f"flavor {flavor!r} has no masked variant")
    if masked and not block_size:
        raise ValueError("masked volume needs the mask block_size")

    if flavor == "omega_xt":
        rounds = n_x // c_omega
        ring_moves = (_perm_moves(g.stagger_perm("xlike", "omega", n_x))
                      + rounds * _perm_moves(g.shift_perm("omega", c_omega)))
        ring = Fraction(ring_moves * blk_x * n * w)
        finish = collective_wire_bytes("psum", blk_om * n * w, c_omega)
        return CommVolume(flavor, rounds, ring, finish)

    # gather flavors: (ring ordering, fixed-operand replication c_F,
    # rotating block count n_R, canonical layout, rotating payload,
    # gathered tile (rows, cols), team-layer extent)
    if flavor == "xtx":
        ring_name, c_f, n_r, canon = "x", c_x, n_x, "xlike"
        payload, tile, team = blk_x * n, (blk_x, blk_x), c_x
    elif flavor == "omega_s":
        canon = canonical or "omegalike"
        n_r = n_om if canon == "omegalike" else n_x
        blk_r = p // n_r
        ring_name, c_f = "x", c_x
        payload, tile, team = blk_r * p, (blk_r, blk_x), c_x
    elif flavor == "y_x":
        ring_name, c_f, n_r, canon = "omega", c_omega, n_x, "xlike"
        payload, tile, team = n * blk_x, (blk_om, blk_x), c_omega
    else:
        raise ValueError(f"unknown flavor {flavor!r}")

    rounds = max(1, n_r // c_f)
    moves = (_perm_moves(g.stagger_perm(canon, ring_name, n_r))
             + rounds * _perm_moves(g.shift_perm(ring_name, c_f)))
    ring = Fraction(moves * payload * w)
    if masked:   # the occupancy mask rides the same stagger + shifts
        rows, cols = (p // n_r) // block_size, p // block_size
        ring += Fraction(moves * rows * cols * DTYPE_BYTES["int8"])
    finish = collective_wire_bytes(
        "all_gather", rounds * tile[0] * tile[1] * w, team)
    return CommVolume(flavor, rounds, ring, finish)


def ring_allreduce_int8_volume(size: int, extent: int, *,
                               dtype: str = "float64") -> Fraction:
    """Exact bytes of ``comm.collectives.ring_allreduce_int8`` on an input
    of ``size`` elements of ``dtype`` (the reference's: float64) over a
    ring of ``extent`` devices.

    (extent-1) reduce-scatter rounds each ship one int8 chunk plus its
    scale scalar in ``dtype``; the finishing all_gather ships the REDUCED
    chunk at full width — int8 compression buys its 8x (float64; 4x at
    float32) only on the reduce-scatter phase, which is the phase that
    repeats.
    """
    if extent <= 1:
        return Fraction(0)
    pad = (-size) % extent
    chunk = (size + pad) // extent
    width = DTYPE_BYTES[dtype]
    rs = (extent - 1) * (chunk * DTYPE_BYTES["int8"] + width)
    ag = collective_wire_bytes("all_gather", chunk * width, extent)
    return Fraction(rs) + ag


def compressed_psum_volume(size: int, extent: int, *,
                           method: str = "bf16") -> Fraction:
    """Exact bytes of ``comm.collectives.compressed_psum``: one
    bandwidth-optimal all-reduce of ``size`` elements at the method's
    wire width (bf16 = 2 bytes; the int8 method
    psums the DEQUANTIZED float32 values — its 1-byte wire only exists in
    the explicit ring)."""
    wire = {"bf16": DTYPE_BYTES["bfloat16"], "int8": DTYPE_BYTES["float32"],
            "none": DTYPE_BYTES["float64"]}[method]
    return collective_wire_bytes("psum", size * wire, extent)
