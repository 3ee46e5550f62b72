"""The port's kernel registry: one entry per hand-written CUDA kernel.

Port of ``repro.kernels.manifest.KERNEL_ENTRIES``, reduced to what a
kernel on the card is checked by: the reference entry it ports, the TPU
kernel body it replaces, its CUDA source, the tolerance of each output
class, and the reference's configs copied as literals (the parity tests
hold them equal to the reference's).  ``chip_smoke.py`` and the card-only
tests run every config through the kernel and its plain version.

The problem builders are numpy only and draw exactly what the
reference's builders draw from the same generator.
"""
from __future__ import annotations

import numpy as np

from .ref import dense_to_block_csr

#: the reference's kernel entries that no port entry covers yet, with the
#: slice of the port that brings each
NOT_PORTED: dict[str, str] = {}

KERNEL_ENTRIES = (
    {
        "name": "fused_prox_stats",
        "jax_entry": "kernels.softthresh.fused_prox_stats",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/softthresh.cu",
        # `_kernel` (:71) and `_kernel_weighted` (:82): one CUDA kernel
        # with a weight operand
        "replaces": ("src/repro/kernels/softthresh.py:71",
                     "src/repro/kernels/softthresh.py:82"),
        # out, min_diag and block_nnz are bit-exact; logdet, l1 and sumsq
        # differ by summation order (and the device log)
        "exact": ("out", "min_diag", "block_nnz"),
        "rtol": {"float64": 1e-12, "float32": 1e-5},
        "configs": (
            {"label": "aligned", "m": 32, "n": 32, "block": (16, 16)},
            {"label": "edge-tile", "m": 40, "n": 24, "block": (16, 16)},
            {"label": "prime-p", "m": 13, "n": 13, "block": (8, 8)},
            {"label": "weighted-inf-alpha0", "m": 24, "n": 24,
             "block": (16, 16), "weighted": True, "alpha": 0.0},
        ),
    },
    {
        "name": "fused_path_step",
        "jax_entry": "kernels.pathstep.fused_path_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pathstep.cu",
        # `_kernel` (:106) and `_kernel_weighted` (:116): one CUDA kernel
        # with a weight operand
        "replaces": ("src/repro/kernels/pathstep.py:106",
                     "src/repro/kernels/pathstep.py:116"),
        # cand is bit-exact; the five per-lane stats differ by summation
        # order (the nonzero count is exact in both)
        "exact": ("cand",),
        "rtol": {"float64": 1e-12, "float32": 1e-5},
        "configs": (
            {"label": "aligned", "c": 2, "p": 16, "block": 8},
            {"label": "prime-p-full-tile", "c": 2, "p": 13, "block": 8},
            {"label": "odd-divisor-edge", "c": 1, "p": 12, "block": 8},
            {"label": "weighted-inf-alpha0", "c": 2, "p": 8, "block": 4,
             "weighted": True, "zero_lam1_lane": True},
        ),
    },
    {
        "name": "blocksparse_matmul",
        "jax_entry": "kernels.blocksparse_matmul.blocksparse_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/blocksparse_matmul.cu",
        "replaces": ("src/repro/kernels/blocksparse_matmul.py:30",),
        # fp-tolerant: the association order of the sums differs
        "exact": (),
        "rtol": {"float64": 1e-10, "float32": 1e-4},
        "configs": (
            {"label": "dense", "p": 16, "bs": 8, "m": 16, "block_n": 8,
             "density": 1.0, "seed": 1},
            {"label": "partial", "p": 32, "bs": 8, "m": 16, "block_n": 8,
             "density": 0.4, "seed": 2},
            {"label": "empty-rows", "p": 16, "bs": 4, "m": 8,
             "block_n": 8, "density": 0.0, "seed": 3},
            {"label": "edge-n", "p": 16, "bs": 8, "m": 12, "block_n": 8,
             "density": 0.7, "seed": 4},
        ),
    },
    {
        "name": "flash_attention",
        "jax_entry": "kernels.flash_attention.flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": ("src/repro/kernels/flash_attention.py:34",),
        # online softmax against the materialized one: float32 summation
        # order (the reference's 2e-3).  In bfloat16 both sides see the
        # same bf16 inputs; the kernel's tensor-core body also rounds the
        # probabilities to bf16 for P V (2^-9 relative each), and the
        # output is rounded once: at most ~2 bf16 ulps apart, 2^-6 =
        # 1.6e-2 relative (atol the same, for outputs near zero)
        "exact": (),
        "rtol": {"float32": 2e-3, "bfloat16": 1.6e-2},
        # the kernel's blocking is its own (64 x 64 tiles); block_q and
        # block_k are the reference's and only label the configs
        "configs": (
            {"label": "causal-gqa", "B": 1, "Hq": 2, "Hkv": 1, "Lq": 32,
             "Lkv": 32, "D": 16, "block_q": 16, "block_k": 16,
             "causal": True},
            {"label": "window-softcap-edge", "B": 1, "Hq": 2, "Hkv": 2,
             "Lq": 40, "Lkv": 40, "D": 16, "block_q": 16, "block_k": 16,
             "causal": False, "window": 16, "softcap": 10.0},
            {"label": "decode-tail", "B": 1, "Hq": 2, "Hkv": 1, "Lq": 8,
             "Lkv": 40, "D": 16, "block_q": 8, "block_k": 16,
             "causal": True},
        ),
    },
)


def entry(name: str) -> dict:
    return next(e for e in KERNEL_ENTRIES if e["name"] == name)


def softthresh_problem(cfg, rng, weighted: bool):
    """(z, diag_mask, weights or None) for a fused-prox config: a random z
    with a positive diagonal; ``weighted`` adds weights, ~15% of them
    inf."""
    m, n = cfg["m"], cfg["n"]
    z = rng.standard_normal((m, n))
    idx = np.arange(min(m, n))
    z[idx, idx] = np.abs(z[idx, idx]) + 0.1
    mask = np.zeros((m, n))
    mask[idx, idx] = 1.0
    w = None
    if weighted:
        w = np.abs(rng.standard_normal((m, n))) + 0.1
        w[rng.random((m, n)) < 0.15] = np.inf
    return z, mask, w


def blocksparse_problem(cfg, rng):
    """(a, values, row_idx, col_idx, b) for a block-sparse config, drawn
    as the reference's ``_bsr_problem`` draws them."""
    p, bs = cfg["p"], cfg["bs"]
    nbr = p // bs
    a = rng.standard_normal((p, p))
    keep = rng.random((nbr, nbr)) < cfg["density"]
    a = np.where(np.repeat(np.repeat(keep, bs, 0), bs, 1), a, 0.0)
    vals, rows, cols = dense_to_block_csr(a, bs)
    b = rng.standard_normal((p, cfg["m"]))
    return a, vals, rows, cols, b


def pathstep_problem(cfg, rng):
    """(omega, w, tau, lam1, lam2, weights or None) for a path-step
    config, drawn as the reference's ``_pathstep_problem`` draws them: a
    lane-stacked omega with a safe positive diagonal, a random W, ~15% inf
    weights, and lane 0's lam1 zeroed where the config asks (the inf
    guard must still force zeros at tau * lam1 = 0)."""
    c, p = cfg["c"], cfg["p"]
    om = 0.1 * rng.standard_normal((c, p, p))
    idx = np.arange(p)
    om[:, idx, idx] = np.abs(om[:, idx, idx]) + 1.0
    w = rng.standard_normal((c, p, p))
    tau = 0.3 + 0.1 * np.arange(c)
    lam1 = 0.05 + 0.02 * np.arange(c)
    lam2 = np.full(c, 0.01)
    weights = None
    if cfg.get("weighted"):
        wt = np.abs(rng.standard_normal((c, p, p))) + 0.1
        wt[rng.random((c, p, p)) < 0.15] = np.inf
        weights = wt
        if cfg.get("zero_lam1_lane"):
            lam1[0] = 0.0
    return om, w, tau, lam1, lam2, weights


def flash_problem(cfg, rng):
    """(q, k, v, kwargs) for a flash-attention config, drawn as the
    reference's ``_flash_fuzz`` draws them: standard normal q (B, Hq, Lq,
    D), then k and v (B, Hkv, Lkv, D); kwargs are the config's causal,
    window and softcap."""
    B, Hq, Hkv = cfg["B"], cfg["Hq"], cfg["Hkv"]
    Lq, Lkv, D = cfg["Lq"], cfg["Lkv"], cfg["D"]
    q = rng.standard_normal((B, Hq, Lq, D))
    k = rng.standard_normal((B, Hkv, Lkv, D))
    v = rng.standard_normal((B, Hkv, Lkv, D))
    kw = dict(causal=cfg.get("causal", True), window=cfg.get("window"),
              softcap=cfg.get("softcap"))
    return q, k, v, kw
