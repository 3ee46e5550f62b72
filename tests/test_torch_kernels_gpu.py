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
STEP = tman.entry("fused_path_step")


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


def _step_cases():
    for cfg in STEP["configs"]:
        for weighted in sorted({False, bool(cfg.get("weighted"))}):
            for dt in ("float64", "float32"):
                yield pytest.param(cfg, weighted, dt,
                                   id=f"{cfg['label']}-w{int(weighted)}-{dt}")


@pytest.mark.gpu
@pytest.mark.parametrize("cfg,weighted,dt", list(_step_cases()))
def test_path_step_kernel_matches_plain_on_card(cuda, cfg, weighted, dt):
    """One launch per call; cand bit-exact against the plain version on
    the same card inputs, the per-lane stats within the manifest's rtol
    (the nonzero count exact)."""
    om, w, tau, lam1, lam2, wts = tman.pathstep_problem(
        {**cfg, "weighted": weighted}, np.random.default_rng(0))
    tdt = getattr(torch, dt)
    args = [torch.as_tensor(a, dtype=tdt, device=cuda)
            for a in (om, w, tau, lam1, lam2)]
    wt = None if wts is None else torch.as_tensor(wts, dtype=tdt,
                                                  device=cuda)
    tops.reset_launches()
    cand, stats = tops.fused_path_step(*args, weights=wt,
                                       block=cfg["block"])
    torch.cuda.synchronize()
    assert tops.LAUNCHES["fused_path_step"] == 1
    want_c, want_s = tref.fused_path_step(*args, weights=wt)
    assert cand.dtype == tdt and stats.dtype == tdt
    assert torch.equal(cand, want_c)
    tol = STEP["rtol"][dt]
    torch.testing.assert_close(stats, want_s, rtol=tol, atol=tol)
    assert torch.equal(stats[:, 4], want_s[:, 4])


@pytest.mark.gpu
def test_path_step_kernel_shared_weights_and_refusals_on_card(cuda):
    om, w, tau, lam1, lam2, _ = tman.pathstep_problem(
        {"c": 3, "p": 40}, np.random.default_rng(1))
    args = [torch.as_tensor(a, device=cuda) for a in (om, w, tau, lam1,
                                                      lam2)]
    shared = torch.rand((40, 40), dtype=torch.float64, device=cuda) + 0.5
    shared[2, 7] = shared[7, 2] = float("inf")
    got = tops.fused_path_step(*args, weights=shared)
    want = tref.fused_path_step(*args, weights=shared)
    assert torch.equal(got[0], want[0])
    with pytest.raises(ValueError, match="contiguous"):
        tops.fused_path_step(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(TypeError):
        tops.fused_path_step(args[0], args[1].float(), *args[2:])

