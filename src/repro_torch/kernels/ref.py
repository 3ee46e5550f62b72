"""Plain PyTorch versions of every kernel in this package.

The port of ``repro.kernels.ref``.  Each function computes exactly what
its CUDA kernel computes, in eager torch on any device.  ``kernels.ops``
routes a CPU tensor here; ``chip_smoke.py`` runs these on the card as the
yardstick each kernel is held against.  Nothing on the main path calls
them when a card is present.
"""
from __future__ import annotations

import math

import numpy as np
import torch

#: floor dtype of the fused-prox stats: at least float32, widened to the
#: operand dtype (a float64 solve keeps float64 line-search stats)
STATS_MIN_DTYPE = torch.float32


#: attention's softmax and accumulation dtype: its own contract (the
#: reference's float32 softmax), not the solver's float64 one
ATTENTION_DTYPE = torch.float32


def stats_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, STATS_MIN_DTYPE)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# fused prox (softthresh)
# ---------------------------------------------------------------------------

def fused_prox(z: torch.Tensor, diag_mask, alpha, *,
               weights=None) -> torch.Tensor:
    """Soft-threshold off-diagonal entries, pass the diagonal through.

    ``diag_mask=None`` means the main diagonal (i == j), copied from
    ``z``; an explicit 0/1 mask is blended as ``st*(1-m) + z*m``.
    ``weights`` switches to the threshold ``alpha * w`` with ``w = inf``
    forcing exact zeros, even at ``alpha == 0``."""
    if weights is None:
        thr = alpha
    else:
        w = torch.as_tensor(weights, dtype=z.dtype, device=z.device)
        thr = torch.where(torch.isinf(w), torch.full_like(w, math.inf),
                          alpha * w)
    st = torch.sign(z) * torch.clamp_min(torch.abs(z) - thr, 0.0)
    if diag_mask is None:
        st.diagonal().copy_(z.diagonal())
        return st
    return st * (1.0 - diag_mask) + z * diag_mask


def block_nnz(a: torch.Tensor, block) -> torch.Tensor:
    """Per-tile nonzero count on the fused-prox stats grid (edge tiles
    zero-padded), in the stats dtype."""
    m, n = a.shape
    bm, bn = min(block[0], m), min(block[1], n)
    gm, gn = _cdiv(m, bm), _cdiv(n, bn)
    ap = torch.nn.functional.pad(a, (0, gn * bn - n, 0, gm * bm - m))
    tiles = (ap != 0).reshape(gm, bm, gn, bn)
    return tiles.sum(dim=(1, 3)).to(stats_dtype(a.dtype))


def fused_prox_stats(z: torch.Tensor, diag_mask, alpha, *, weights=None,
                     block=(128, 128)):
    """Prox + the line-search reduction pieces.

    Returns (out, logdet, l1_offdiag, sumsq, min_diag, block_nnz):
      logdet     = sum over the diagonal of log(max(out, 1e-30))
      l1_offdiag = sum over the off-diagonal of |out| (unweighted)
      sumsq      = ||out||_F^2
      min_diag   = min over the diagonal of out
      block_nnz  = per-tile nonzero counts (the block-occupancy harvest)
    """
    out = fused_prox(z, diag_mask, alpha, weights=weights)
    sd = stats_dtype(z.dtype)
    if diag_mask is None:
        dvals = out.diagonal()
        logdet = torch.log(torch.clamp_min(dvals, 1e-30)).sum()
        l1 = torch.abs(out).sum() - torch.abs(dvals).sum()
        min_diag = (dvals.min() if dvals.numel()
                    else torch.tensor(math.inf, dtype=out.dtype,
                                      device=out.device))
    else:
        d = diag_mask > 0
        zero = torch.zeros((), dtype=out.dtype, device=out.device)
        logdet = torch.where(d, torch.log(torch.clamp_min(out, 1e-30)),
                             zero).sum()
        l1 = torch.where(d, zero, torch.abs(out)).sum()
        min_diag = torch.where(d, out, torch.full_like(out, math.inf)).min()
    sumsq = (out * out).sum()
    return (out, logdet.to(sd), l1.to(sd), sumsq.to(sd), min_diag.to(sd),
            block_nnz(out, block))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<A, B> as one BLAS dot over the flattened operands (the solver's
    ``core.objective.dot``)."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def fused_prox_trial(omega: torch.Tensor, grad: torch.Tensor, tau, alpha,
                     *, weights=None, block=(128, 128)):
    """One line-search trial of the prox loop: the trial entry of the
    fused prox kernel.

    Returns (out, diff_sq, diff_grad, sumsq, block_nnz) with
      out       = the prox of z = omega - tau * grad at threshold
                  ``alpha`` (``weights`` as in :func:`fused_prox`), the
                  main diagonal exempt
      diff_sq   = <d, d> and diff_grad = <d, grad>, d = out - omega
      sumsq     = ||out||_F^2
      block_nnz = per-tile nonzero counts of out
    op by op as the prox loop's unfused trial computes them (z as two
    eager ops, the inner products as one BLAS dot each), so a CPU solve
    gives the same bits either way."""
    z = omega - tau * grad
    out = fused_prox(z, None, alpha, weights=weights)
    del z
    diff = out - omega
    dd = _dot(diff, diff)
    dg = _dot(diff, grad)
    del diff
    return out, dd, dg, _dot(out, out), block_nnz(out, block)


# ---------------------------------------------------------------------------
# fused path step (pathstep)
# ---------------------------------------------------------------------------

#: stats columns of the path step: <diff, grad>, <diff, diff>, ||cand||^2,
#: off-diagonal l1 of cand, nonzeros of cand
PATH_STEP_STATS = 5


def _lanes(v, c: int, like: torch.Tensor) -> torch.Tensor:
    """A per-lane scalar (float, 0-d or (C,)) as a (C, 1, 1) tensor in
    ``like``'s dtype and device."""
    t = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return t.expand(c).reshape(c, 1, 1)


def fused_path_step(omega: torch.Tensor, w: torch.Tensor, tau, lam1, lam2,
                    *, weights=None):
    """One flat step of the batched path engine for C stacked lanes.

    omega/w: (C, p, p) lane iterates and their products W = Omega S;
    tau/lam1/lam2: per-lane scalars ((C,) or broadcast); ``weights``
    ((C, p, p) or one shared (p, p)) switches to the threshold
    ``tau * lam1 * w``, with ``w = inf`` forcing exact zeros even at
    lam1 == 0.  Returns ``(cand, stats)``: the (C, p, p) prox candidates
    and the (C, 5) per-lane sums ``[<diff, grad>, <diff, diff>,
    ||cand||_F^2, l1_offdiag, nnz]`` with ``diff = cand - omega``.

    The op order is the reference's (``repro.kernels.ref``): grad =
    0.5 * (W + W^T) + lam2 * Omega, then -1/Omega on the diagonal (taken
    on the diagonal only, which gives the same values), z = Omega -
    tau * grad, the soft threshold off the diagonal and z on it."""
    c = omega.shape[0]
    tau_l = _lanes(tau, c, omega)
    alpha = tau_l * _lanes(lam1, c, omega)
    grad = w + w.mT
    grad.mul_(0.5)
    grad += _lanes(lam2, c, omega) * omega
    grad.diagonal(dim1=-2, dim2=-1).sub_(
        1.0 / omega.diagonal(dim1=-2, dim2=-1))
    z = omega - tau_l * grad
    if weights is None:
        thr = alpha
    else:
        wt = torch.as_tensor(weights, dtype=omega.dtype, device=omega.device)
        thr = (alpha * wt).masked_fill_(torch.isinf(wt), math.inf)
    # sign(z) * max(|z| - thr, 0), each op rounded, on one buffer
    cand = torch.abs(z).sub_(thr).clamp_min_(0.0).mul_(torch.sign(z))
    del thr
    cand.diagonal(dim1=-2, dim2=-1).copy_(z.diagonal(dim1=-2, dim2=-1))
    del z
    sd = stats_dtype(omega.dtype)
    diff = cand - omega
    red = lambda x: x.sum(dim=(-2, -1)).to(sd)   # noqa: E731
    dg = red(diff * grad)
    del grad
    dd = red(diff * diff)
    del diff
    off = torch.abs(cand)
    off.diagonal(dim1=-2, dim2=-1).zero_()
    l1 = red(off)
    del off
    stats = torch.stack([dg, dd, red(cand * cand), l1,
                         (cand != 0).sum(dim=(-2, -1)).to(sd)], dim=-1)
    return cand, stats


# ---------------------------------------------------------------------------
# block-sparse x dense matmul (blocksparse_matmul)
# ---------------------------------------------------------------------------

def block_csr_to_dense(values: torch.Tensor, row_idx, col_idx,
                       p: int) -> torch.Tensor:
    """Materialize a block-CSR matrix (nb, bs, bs) into dense (p, p)."""
    bs = values.shape[1]
    dense = torch.zeros((p, p), dtype=values.dtype, device=values.device)
    for i, (r, c) in enumerate(zip(torch.as_tensor(row_idx).tolist(),
                                   torch.as_tensor(col_idx).tolist())):
        dense[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] = values[i]
    return dense


def blocksparse_matmul(values, row_idx, col_idx, b, p: int) -> torch.Tensor:
    """A @ B with A given in block-CSR coordinates."""
    return block_csr_to_dense(values, row_idx, col_idx, p) @ b


def dense_to_block_csr(a: np.ndarray, bs: int, *, tol: float = 0.0):
    """Host-side: dense (p, p) -> (values, row_idx, col_idx) keeping only
    nonzero bs x bs tiles; every block-row gets at least one (zero) block,
    as in the reference's builder."""
    a = np.asarray(a)
    p = a.shape[0]
    nbr = p // bs
    vals, rows, cols = [], [], []
    for r in range(nbr):
        found = False
        for c in range(nbr):
            blk = a[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs]
            if np.abs(blk).max() > tol:
                vals.append(blk)
                rows.append(r)
                cols.append(c)
                found = True
        if not found:
            vals.append(np.zeros((bs, bs), a.dtype))
            rows.append(r)
            cols.append(r)
    return (np.stack(vals), np.asarray(rows, np.int32),
            np.asarray(cols, np.int32))


def masked_matmul(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor, *,
                  block_size: int, capacity: int) -> torch.Tensor:
    """Block-gather product: C = A @ B using only the occupied bs x bs
    tiles of A (up to ``capacity`` of them, occupied first).

    The port of ``repro.core.matops.masked_matmul``: gather the tiles,
    batch-multiply them against the matching row-blocks of B, and sum by
    block row with ``index_add_`` (the reference's ``segment_sum``).
    Exact whenever the occupied-block count is <= ``capacity``."""
    p, k = a.shape
    m = b.shape[1]
    bs = block_size
    nbr, nbc = mask.shape
    ap = torch.nn.functional.pad(a, (0, nbc * bs - k, 0, nbr * bs - p))
    bp = torch.nn.functional.pad(b, (0, 0, 0, nbc * bs - b.shape[0]))
    occupied = mask.reshape(-1) > 0
    order = torch.argsort((~occupied).to(torch.int8), stable=True)
    idx = order[:capacity]
    r_idx = idx // nbc
    c_idx = idx % nbc
    a4 = ap.reshape(nbr, bs, nbc, bs)
    vals = a4[r_idx, :, c_idx, :]                  # (capacity, bs, bs)
    vals = vals * occupied[idx][:, None, None].to(vals.dtype)
    b3 = bp.reshape(nbc, bs, m)
    prods = torch.bmm(vals, b3[c_idx])
    out = torch.zeros((nbr, bs, m), dtype=prods.dtype, device=prods.device)
    out.index_add_(0, r_idx, prods)
    return out.reshape(nbr * bs, m)[:p]


# ---------------------------------------------------------------------------
# flash attention (flash_attention)
# ---------------------------------------------------------------------------

def attention(q, k, v, *, causal=True, window=None, softcap=None,
              scale=None):
    """Multi-head attention with GQA, causal/sliding-window masks and
    logit soft-capping: the port of the reference's oracle.

    q: (B, Hq, Lq, D); k, v: (B, Hkv, Lkv, D) with Hkv | Hq.  window:
    attend to keys in (qpos - window, qpos], qpos aligned so the last
    query sees the last key.  As in the reference, the default scale is
    1/sqrt(D) rounded to q's dtype and the logits are taken in q's dtype;
    the softmax runs in float32."""
    B, Hq, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kq = torch.repeat_interleave(k, group, dim=1)
    vq = torch.repeat_interleave(v, group, dim=1)
    if scale is None:
        # a 0-d host tensor in q's dtype (no host-to-device copy)
        scale = 1.0 / torch.sqrt(torch.tensor(float(D))).to(q.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kq) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(Lq, device=q.device)[:, None] + (Lkv - Lq)
    kpos = torch.arange(Lkv, device=q.device)[None, :]
    mask = torch.ones((Lq, Lkv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits.to(ATTENTION_DTYPE), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vq)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None):
    """The flash kernel's plain version: :func:`attention` on float32
    upcasts of the inputs at the kernel's scale (D ** -0.5 unless given),
    cast back to q's dtype.  That is the kernel's arithmetic (float32
    logits, softmax and accumulation) in another summation order."""
    D = q.shape[-1]
    scale = float(D) ** -0.5 if scale is None else float(scale)
    f32 = ATTENTION_DTYPE
    out = attention(q.to(f32), k.to(f32), v.to(f32), causal=causal,
                    window=window, softcap=softcap, scale=scale)
    return out.to(q.dtype)
