"""Device dispatch for the kernels, with a launch count per kernel.

Port of ``repro.kernels.ops``.  Where the reference chose interpret mode
by backend, the port chooses by the device of the tensor it is given:

  * a CPU tensor goes to the plain PyTorch version (``kernels.ref``);
  * a CUDA tensor goes to the hand-written kernel, or the call raises.

Nothing here catches a failed build or launch and falls back.

:data:`LAUNCHES` counts the kernel launches made through these wrappers,
one per launch and nowhere else, so a run can show that its main path
went through the kernels (``chip_smoke.py`` zeroes it with
:func:`reset_launches` before the path and reads it after).
:data:`WEIGHTED_LAUNCHES` counts, of those, the launches with a weight
operand (the reference's ``_kernel_weighted`` bodies).  :data:`CENSUS`
(``repro_torch.census``) counts the run's spans and host syncs beside
them, and :func:`reset_launches` zeroes it too.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from ..census import CENSUS
from . import blocksparse_matmul as _bsmm
from . import flash_attention as _fa
from . import pathstep as _ps
from . import ref
from . import softthresh as _st

#: kernel launches per kernel since the last reset
#: (``fused_prox_stats[trial]`` is the fused prox kernel's trial entry)
LAUNCHES: dict[str, int] = {"fused_prox_stats": 0,
                            "fused_prox_stats[trial]": 0,
                            "blocksparse_matmul": 0, "fused_path_step": 0,
                            "flash_attention": 0}

#: of those, launches with a weight operand, per kernel that takes one
WEIGHTED_LAUNCHES: dict[str, int] = {"fused_prox_stats": 0,
                                     "fused_prox_stats[trial]": 0,
                                     "fused_path_step": 0}


def reset_launches() -> None:
    """Zero the launch counts and the run census (``repro_torch.census``)."""
    for counts in (LAUNCHES, WEIGHTED_LAUNCHES):
        for name in counts:
            counts[name] = 0
    CENSUS.reset()


def _count(name: str, weights) -> None:
    LAUNCHES[name] += 1
    if weights is not None:
        WEIGHTED_LAUNCHES[name] += 1


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"repro_torch kernels run on cpu or cuda tensors, "
                     f"got one on {t.device}")


def fused_prox_stats(z, diag_mask, alpha, *, weights=None,
                     block=_st.DEFAULT_BLOCK):
    """(out, logdet, l1_offdiag, sumsq, min_diag, block_nnz); see
    ``kernels.ref.fused_prox_stats``."""
    if not _on_card(z):
        return ref.fused_prox_stats(z, diag_mask, alpha, weights=weights,
                                    block=block)
    res = _st.fused_prox_stats(z, diag_mask, alpha, weights=weights,
                               block=block)
    _count("fused_prox_stats", weights)
    return res


def fused_prox_trial(omega, grad, tau, alpha, *, weights=None,
                     block=_st.DEFAULT_BLOCK):
    """(out, diff_sq, diff_grad, sumsq, block_nnz) of one line-search
    trial; see ``kernels.ref.fused_prox_trial``.  A launch of the fused
    prox kernel's trial entry, counted under ``fused_prox_stats[trial]``."""
    if not _on_card(omega):
        return ref.fused_prox_trial(omega, grad, tau, alpha, weights=weights,
                                    block=block)
    res = _st.fused_prox_trial(omega, grad, tau, alpha, weights=weights,
                               block=block)
    _count("fused_prox_stats[trial]", weights)
    return res


def fused_path_step(omega, w, tau, lam1, lam2, *, weights=None,
                    block=_ps.DEFAULT_BLOCK):
    """(cand, stats) of one flat step for C stacked lanes; see
    ``kernels.ref.fused_path_step``."""
    if not _on_card(omega):
        return ref.fused_path_step(omega, w, tau, lam1, lam2,
                                   weights=weights)
    res = _ps.fused_path_step(omega, w, tau, lam1, lam2, weights=weights,
                              block=block)
    _count("fused_path_step", weights)
    return res


def blocksparse_matmul(values, row_idx, col_idx, b):
    """A @ B with A in block-CSR coordinates (the reference's contract,
    including its ``ValueError`` on non-contiguous block-row runs)."""
    if not _on_card(b):
        _bsmm.validate_row_runs(row_idx)
        return ref.blocksparse_matmul(values, row_idx, col_idx, b,
                                      p=b.shape[0])
    out = _bsmm.blocksparse_matmul(values, row_idx, col_idx, b)
    LAUNCHES["blocksparse_matmul"] += 1
    return out


def masked_matmul(a, b, mask, *, block_size: int, capacity: int):
    """The sparse branch of the matops dispatch: A @ B over A's occupied
    tiles.  ``capacity`` (>= the occupied-block count) sizes the plain
    version's gather; the kernel visits every occupied tile."""
    if not _on_card(a):
        return ref.masked_matmul(a, b, mask, block_size=block_size,
                                 capacity=capacity)
    out = _bsmm.masked_matmul(a, b, mask, block_size=block_size)
    LAUNCHES["blocksparse_matmul"] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    softcap=None, scale=None):
    """GQA attention with causal / sliding-window masks and softcap, by
    online softmax; see ``kernels.ref.flash_attention``.  On the card it
    is the opaque op ``repro_torch::flash_attention``."""
    _fa.validate(q, k, v, window)
    if not _on_card(q):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    return _flash_attention_op(
        q, k, v, bool(causal), None if window is None else int(window),
        None if softcap is None else float(softcap),
        None if scale is None else float(scale))


# The kernel's launch as an opaque custom op, so that tracing tools see
# one op with a shape rule and a flop count instead of a ctypes call on
# data pointers: under FakeTensorMode (``launch.dryrun``) the fake rule
# runs and nothing is built or launched, and FlopCounterMode counts the
# kernel's visible (query, key) pairs around a real launch as well.


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: Optional[int],
                        softcap: Optional[float],
                        scale: Optional[float]) -> torch.Tensor:
    out = _fa.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, scale=scale)
    LAUNCHES["flash_attention"] += 1
    return out


@_flash_attention_op.register_fake
def _(q, k, v, causal, window, softcap, scale):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, causal, window,
                           softcap, scale, *args, out_shape=None,
                           **kwargs) -> int:
    """4 D Hq B flops per visible (query, key) pair (QK^T and PV), the
    pairs of the causal mask and window: the kernel's work, not L^2."""
    return _fa.flops(q_shape, k_shape, causal=causal, window=window)


# ---------------------------------------------------------------------------
# analysis manifest (repro_torch.analysis.dispatchpass)
# ---------------------------------------------------------------------------

def _analysis_fused_prox(device):
    p = 8
    z = torch.linspace(-1.0, 1.0, p * p, dtype=torch.float64,
                       device=device).reshape(p, p)
    dm = torch.eye(p, dtype=torch.float64, device=device)
    return {"fn": fused_prox_stats, "args": (z, dm, 0.1),
            "kwargs": {"block": (4, 4)}}


def _analysis_fused_prox_trial(device):
    p = 8
    om = (torch.eye(p, dtype=torch.float64, device=device)
          + 0.1 * torch.linspace(-1.0, 1.0, p * p, dtype=torch.float64,
                                 device=device).reshape(p, p))
    return {"fn": fused_prox_trial, "args": (om, om.mT.contiguous(), 0.5,
                                             0.05),
            "kwargs": {"block": (4, 4)}}


def _analysis_fused_path_step(device):
    c, p = 2, 8
    opts = dict(dtype=torch.float64, device=device)
    om = (torch.eye(p, **opts)[None]
          + 0.01 * torch.arange(c * p * p, **opts).reshape(c, p, p)
          / (c * p * p))
    tau = torch.full((c,), 0.5, **opts)
    lam = torch.full((c,), 0.1, **opts)
    return {"fn": fused_path_step, "args": (om, om * 1.5, tau, lam, lam),
            "kwargs": {"block": 4}}


def _analysis_masked_matmul(device):
    p, bs = 16, 4
    opts = dict(dtype=torch.float64, device=device)
    a = torch.linspace(-1.0, 1.0, p * p, **opts).reshape(p, p)
    a[:8, 8:] = 0.0
    mask = (ref.block_nnz(a, (bs, bs)) > 0).to(torch.int8)
    b = torch.linspace(0.0, 1.0, p * 6, **opts).reshape(p, 6)
    return {"fn": masked_matmul, "args": (a, b, mask),
            "kwargs": {"block_size": bs, "capacity": 12}}


#: the kernel dispatch at f64: the kernels on the card (their wrappers'
#: torch ops are what the dispatch engine sees), the plain versions on
#: the CPU
ANALYSIS_ENTRIES = [
    {"name": "kernels.ops.fused_prox_stats",
     "path": "src/repro_torch/kernels/softthresh.py",
     "build": _analysis_fused_prox},
    {"name": "kernels.ops.fused_prox_trial",
     "path": "src/repro_torch/kernels/softthresh.py",
     "build": _analysis_fused_prox_trial},
    {"name": "kernels.ops.fused_path_step",
     "path": "src/repro_torch/kernels/pathstep.py",
     "build": _analysis_fused_path_step},
    {"name": "kernels.ops.masked_matmul",
     "path": "src/repro_torch/kernels/blocksparse_matmul.py",
     "build": _analysis_masked_matmul},
]
