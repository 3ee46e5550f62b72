"""Card-only: each CUDA kernel of the port against its plain version, at
every config of the port's kernel manifest, in float64 and float32.

Marked ``gpu``; without a card they skip.  The module imports neither JAX
nor the JAX package, so it runs on a machine with the card and no JAX
(``--noconftest`` keeps the suite's JAX fixtures out):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import manifest as tman
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_parity import assert_prox_stats, cuda  # noqa: F401

SOFT = tman.entry("fused_prox_stats")
BSR = tman.entry("blocksparse_matmul")


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("cfg", SOFT["configs"], ids=lambda c: c["label"])
def test_fused_prox_kernel_matches_plain_on_card(cuda, cfg, dt):
    rng = np.random.default_rng(0)
    z, mask, w = tman.softthresh_problem(cfg, rng, bool(cfg.get("weighted")))
    tdt = getattr(torch, dt)
    zt = torch.as_tensor(z, dtype=tdt, device=cuda)
    wt = None if w is None else torch.as_tensor(w, dtype=tdt, device=cuda)
    block, alpha = tuple(cfg["block"]), cfg.get("alpha", 0.3)
    for dm in (torch.as_tensor(mask, dtype=tdt, device=cuda), None):
        tops.reset_launches()
        got = tops.fused_prox_stats(zt, dm, alpha, weights=wt, block=block)
        torch.cuda.synchronize()
        assert tops.LAUNCHES["fused_prox_stats"] == 1
        want = tref.fused_prox_stats(zt, dm, alpha, weights=wt, block=block)
        assert_prox_stats(got, want, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("cfg", BSR["configs"], ids=lambda c: c["label"])
def test_blocksparse_kernel_matches_plain_on_card(cuda, cfg, dt):
    tdt = getattr(torch, dt)
    tol = BSR["rtol"][dt]
    a, vals, rows, cols, b = tman.blocksparse_problem(
        cfg, np.random.default_rng(cfg["seed"]))
    at = torch.as_tensor(a, dtype=tdt, device=cuda)
    bt = torch.as_tensor(b, dtype=tdt, device=cuda)
    mask = tref.block_nnz(at, (cfg["bs"], cfg["bs"])).gt(0).to(torch.int8)
    cap = max(1, int(mask.sum()))
    tops.reset_launches()
    got = tops.blocksparse_matmul(
        torch.as_tensor(vals, dtype=tdt, device=cuda), rows, cols, bt)
    got_m = tops.masked_matmul(at, bt, mask, block_size=cfg["bs"],
                               capacity=cap)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["blocksparse_matmul"] == 2
    want = tref.masked_matmul(at, bt, mask, block_size=cfg["bs"],
                              capacity=cap)
    for g in (got, got_m):
        torch.testing.assert_close(g, want, rtol=tol, atol=tol)
        torch.testing.assert_close(g, at @ bt, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_blocksparse_kernel_row_revisit_raises_on_card(cuda):
    vals = torch.ones((3, 4, 4), dtype=torch.float64, device=cuda)
    b = torch.ones((8, 4), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="non-contiguously"):
        tops.blocksparse_matmul(vals, [0, 1, 0], [0, 1, 1], b)
