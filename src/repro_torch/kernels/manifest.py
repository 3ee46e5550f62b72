"""The port's kernel registry: one entry per hand-written CUDA kernel.

Port of ``repro.kernels.manifest.KERNEL_ENTRIES``, reduced to what a
kernel on the card is checked by: the reference entry it ports, the TPU
kernel body it replaces, its CUDA source and ``__global__`` functions,
its plain twin in ``kernels.ref``, its outputs and the tolerance of each
(bit-exact when named in ``exact``, else fp-tolerant at the dtype's
``rtol``), the reference's configs copied as literals (the parity tests
hold them equal to the reference's), ``card_configs`` at the CUDA
kernel's own tile edges, a fuzz builder, and its write contract
(``writes``: the checked build's count of stores per element, "once"
unless the entry declares another with its reason).  ``chip_smoke.py``,
the card-only tests and ``repro_torch.analysis.kernelfuzz`` run every
config through the kernel and its plain version;
``repro_torch.analysis.kernelpass.kcheck`` runs them through the checked
build.

The problem builders are numpy only and draw exactly what the
reference's builders draw from the same generator.  A fuzz builder
``fuzz(cfg, rng, device, dtype, place=place_tensor)`` draws its problem,
places each input with ``place``, runs the kernel through
``kernels.ops`` (the plain version on a CPU tensor) and the plain version
``kernels.ref`` on the same tensors, and returns ``[(output, got, want,
tolerance class), ...]`` as numpy arrays.
"""
from __future__ import annotations

import numpy as np

from .flash_attention import HEAD_DIMS
from .ref import dense_to_block_csr

#: the reference's kernel entries that no port entry covers yet, with the
#: slice of the port that brings each
NOT_PORTED: dict[str, str] = {}

#: the tolerance classes a kernel output may have against its plain twin
#: (the reference's): ``bit-exact`` outputs are compared with
#: assert_array_equal, ``fp-tolerant`` ones with allclose at the entry's
#: rtol (and atol = rtol) for the case's dtype
TOLERANCE_CLASSES = ("bit-exact", "fp-tolerant")

#: kernel-package files shared by every entry: a change to one of these
#: re-fuzzes the whole registry under ``--changed``
SHARED_KERNEL_FILES = (
    "src/repro_torch/kernels/manifest.py",
    "src/repro_torch/kernels/ops.py",
    "src/repro_torch/kernels/ref.py",
    "src/repro_torch/kernels/build.py",
)


#: the write contracts an output or scratch buffer may have in the
#: checked build: "once" (every element stored exactly once by one launch;
#: a scratch element at most once) or "many" (stored more than once, by
#: design)
WRITE_CONTRACTS = ("once", "many")


def entry(name: str) -> dict:
    return next(e for e in KERNEL_ENTRIES if e["name"] == name)


def write_contract(ent: dict, buffer: str) -> str:
    """The declared write contract of ``buffer`` (a wrapper's output or
    scratch name): ``ent["writes"][buffer]`` is ``(contract, reason)``,
    and a buffer it does not name is stored exactly once."""
    declared = ent.get("writes", {}).get(buffer)
    return "once" if declared is None else declared[0]


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


# ---------------------------------------------------------------------------
# fuzz builders: the kernel (through ops) against its plain version (ref)
# ---------------------------------------------------------------------------

#: the fused prox's outputs, in the order both routes return them
PROX_OUTPUTS = ("out", "logdet", "l1_offdiag", "sumsq", "min_diag",
                "block_nnz")

#: the outputs of its trial entry (``fused_prox_trial``), in order
TRIAL_OUTPUTS = ("out", "diff_sq", "diff_grad", "sumsq", "block_nnz")

#: the trial entry's step size in the fuzz cases (its threshold is the
#: config's alpha)
TRIAL_TAU = 0.7


def tolerance_class(ent: dict, output: str) -> str:
    """The declared class of ``output`` (a ``prefix:`` names a second call
    of the same outputs)."""
    return ("bit-exact" if output.rsplit(":", 1)[-1] in ent["exact"]
            else "fp-tolerant")


def _to_numpy(t):
    """A host numpy copy; bfloat16 (which numpy lacks) widens to float32
    exactly."""
    import torch
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def _pairs(ent: dict, names, got, want, prefix: str = "") -> list:
    return [(prefix + nm, _to_numpy(g), _to_numpy(w),
             tolerance_class(ent, nm)) for nm, g, w in zip(names, got, want)]


def place_tensor(a, device, dtype):
    """The builders' default placement of an input: a fresh tensor of
    ``dtype`` on ``device`` (``analysis.kernelfuzz.Guard.place`` puts
    float inputs inside guard bands instead)."""
    import torch
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)


def _softthresh_fuzz(cfg, rng, device, dtype, place=place_tensor):
    """Explicit diagonal mask (the reference's case), the implicit
    diagonal (``diag_mask=None``, the solver's), and the trial entry
    (``trial:``) with z as Omega and a gradient drawn after the problem."""
    from . import ops, ref
    ent = entry("fused_prox_stats")
    z, mask, w = softthresh_problem(cfg, rng, bool(cfg.get("weighted")))
    zt, mt = place(z, device, dtype), place(mask, device, dtype)
    wt = None if w is None else place(w, device, dtype)
    alpha, block = cfg.get("alpha", 0.3), tuple(cfg["block"])
    out = []
    for prefix, dm in (("", mt), ("implicit:", None)):
        got = ops.fused_prox_stats(zt, dm, alpha, weights=wt, block=block)
        want = ref.fused_prox_stats(zt, dm, alpha, weights=wt, block=block)
        out += _pairs(ent, PROX_OUTPUTS, got, want, prefix)
    gt = place(rng.standard_normal(z.shape), device, dtype)
    got = ops.fused_prox_trial(zt, gt, TRIAL_TAU, alpha, weights=wt,
                               block=block)
    want = ref.fused_prox_trial(zt, gt, TRIAL_TAU, alpha, weights=wt,
                                block=block)
    return out + _pairs(ent, TRIAL_OUTPUTS, got, want, "trial:")


def _pathstep_fuzz(cfg, rng, device, dtype, place=place_tensor):
    from . import ops, ref
    ent = entry("fused_path_step")
    *arrays, weights = pathstep_problem(cfg, rng)
    args = [place(a, device, dtype) for a in arrays]
    wt = None if weights is None else place(weights, device, dtype)
    got = ops.fused_path_step(*args, weights=wt, block=cfg["block"])
    want = ref.fused_path_step(*args, weights=wt)
    return _pairs(ent, ent["outputs"], got, want)


def _blocksparse_fuzz(cfg, rng, device, dtype, place=place_tensor):
    """The block-CSR entry and the mask entry (the solver's) of kernel 2."""
    import torch

    from . import ops, ref
    ent = entry("blocksparse_matmul")
    a, vals, rows, cols, b = blocksparse_problem(cfg, rng)
    at, bt = place(a, device, dtype), place(b, device, dtype)
    vt = place(vals, device, dtype)
    rt, ct = (torch.as_tensor(x, device=device) for x in (rows, cols))
    got = ops.blocksparse_matmul(vt, rt, ct, bt)
    want = ref.blocksparse_matmul(vt, rt, ct, bt, p=cfg["p"])
    bs = cfg["bs"]
    mask = (ref.block_nnz(at, (bs, bs)) > 0).to(torch.int8)
    cap = max(1, int(mask.sum()))
    got_m = ops.masked_matmul(at, bt, mask, block_size=bs, capacity=cap)
    want_m = ref.masked_matmul(at, bt, mask, block_size=bs, capacity=cap)
    return (_pairs(ent, ("out",), (got,), (want,))
            + _pairs(ent, ("out",), (got_m,), (want_m,), "masked:"))


def _flash_fuzz(cfg, rng, device, dtype, place=place_tensor):
    from . import ops, ref
    ent = entry("flash_attention")
    q, k, v, kw = flash_problem(cfg, rng)
    q, k, v = (place(x, device, dtype) for x in (q, k, v))
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention(q, k, v, **kw)
    return _pairs(ent, ("out",), (got,), (want,))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

KERNEL_ENTRIES = (
    {
        "name": "fused_prox_stats",
        "jax_entry": "kernels.softthresh.fused_prox_stats",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/softthresh.cu",
        # the trial entry is the port's own: one line-search trial in one
        # pass (z = omega - tau * grad, the prox, the step norms)
        "kernels": ("fused_prox_stats_kernel",
                    "fused_prox_stats_trial_kernel"),
        "oracle": "fused_prox_stats",
        "outputs": PROX_OUTPUTS + tuple(f"trial:{o}" for o in TRIAL_OUTPUTS),
        # `_kernel` (:71) and `_kernel_weighted` (:82): one CUDA kernel
        # with a weight operand
        "replaces": ("src/repro/kernels/softthresh.py:71",
                     "src/repro/kernels/softthresh.py:82"),
        # out, min_diag and block_nnz are bit-exact; logdet, l1 and sumsq
        # differ by summation order (and the device log), as do the trial
        # entry's diff_sq, diff_grad and sumsq
        "exact": ("out", "min_diag", "block_nnz"),
        "rtol": {"float64": 1e-12, "float32": 1e-5},
        "configs": (
            {"label": "aligned", "m": 32, "n": 32, "block": (16, 16)},
            {"label": "edge-tile", "m": 40, "n": 24, "block": (16, 16)},
            {"label": "prime-p", "m": 13, "n": 13, "block": (8, 8)},
            {"label": "weighted-inf-alpha0", "m": 24, "n": 24,
             "block": (16, 16), "weighted": True, "alpha": 0.0},
        ),
        # the CUDA kernel's own edges: a prime p past one 128 stats tile
        # (ragged tiles both ways), a weighted one with inf weights, and
        # an even p past two tiles at alpha 0 (the trial entry's 16-byte
        # accesses; an odd p takes its one-element ones)
        "card_configs": (
            {"label": "card-prime-p", "m": 131, "n": 131,
             "block": (128, 128)},
            {"label": "card-ragged-rect", "m": 257, "n": 131,
             "block": (128, 128)},
            {"label": "card-prime-p-weighted", "m": 131, "n": 131,
             "block": (128, 128), "weighted": True, "alpha": 0.3},
            {"label": "card-even-p-weighted-alpha0", "m": 260, "n": 260,
             "block": (128, 128), "weighted": True, "alpha": 0.0},
        ),
        "fuzz": _softthresh_fuzz,
        "writes": {},   # every output and scratch element stored once
    },
    {
        "name": "fused_path_step",
        "jax_entry": "kernels.pathstep.fused_path_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pathstep.cu",
        "kernels": ("path_step_kernel", "lane_reduce_kernel"),
        "oracle": "fused_path_step",
        "outputs": ("cand", "stats"),
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
        # the kernel's 32 x 32 output tile: a prime p past two tiles, and
        # a weighted one with a zero-lam1 lane
        "card_configs": (
            {"label": "card-prime-p", "c": 3, "p": 67, "block": 256},
            {"label": "card-prime-p-weighted", "c": 2, "p": 37,
             "block": 256, "weighted": True, "zero_lam1_lane": True},
        ),
        "fuzz": _pathstep_fuzz,
        "writes": {},   # every output and scratch element stored once
    },
    {
        "name": "blocksparse_matmul",
        "jax_entry": "kernels.blocksparse_matmul.blocksparse_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/blocksparse_matmul.cu",
        "kernels": ("bsmm_f64_tc", "bsmm_fma"),
        "oracle": "blocksparse_matmul",
        "outputs": ("out", "masked:out"),
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
        # the f64 body's 128 x 128 output tile and the f32 body's 64 x 64:
        # m off both n-tiles, block-rows split across tiles, an odd bs
        # (the 8-byte cp.async path) and an odd m (odd leading dimension)
        "card_configs": (
            {"label": "card-n-edge", "p": 256, "bs": 128, "m": 200,
             "block_n": 128, "density": 0.5, "seed": 5},
            {"label": "card-odd-bs", "p": 60, "bs": 15, "m": 65,
             "block_n": 128, "density": 0.6, "seed": 6},
            {"label": "card-many-tiles", "p": 192, "bs": 16, "m": 130,
             "block_n": 128, "density": 0.7, "seed": 7},
        ),
        "fuzz": _blocksparse_fuzz,
        "writes": {},   # every output and scratch element stored once
    },
    {
        "name": "flash_attention",
        "jax_entry": "kernels.flash_attention.flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "kernels": ("flash_fwd_f32", "flash_fwd_wgmma"),
        "oracle": "flash_attention",
        "outputs": ("out",),
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
        # the kernel's 64-row tiles: Lq = Lkv at 63, 64 and 65 and a
        # decode step (Lq 1), at each head dim it is built for
        "card_configs": tuple(
            cfg for d in HEAD_DIMS for cfg in (
                {"label": f"card-l63-d{d}", "B": 1, "Hq": 2, "Hkv": 1,
                 "Lq": 63, "Lkv": 63, "D": d, "causal": True},
                {"label": f"card-l64-window-softcap-d{d}", "B": 1, "Hq": 2,
                 "Hkv": 2, "Lq": 64, "Lkv": 64, "D": d, "causal": True,
                 "window": 32, "softcap": 10.0},
                {"label": f"card-l65-full-d{d}", "B": 1, "Hq": 4, "Hkv": 2,
                 "Lq": 65, "Lkv": 65, "D": d, "causal": False},
                {"label": f"card-decode-d{d}", "B": 2, "Hq": 2, "Hkv": 1,
                 "Lq": 1, "Lkv": 65, "D": d, "causal": True},
            )),
        "fuzz": _flash_fuzz,
        "writes": {},   # every output and scratch element stored once
    },
)
