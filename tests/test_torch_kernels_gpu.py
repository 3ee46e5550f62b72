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

from repro_torch.analysis import kernelfuzz, kernelpass
from repro_torch.kernels import flash_attention as tfa
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


def _offset(t):
    """``t``'s values in a view one element into its storage (not 16-byte
    aligned)."""
    return None if t is None else torch.cat(
        [t.new_zeros(1), t.flatten()])[1:].view(t.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("cfg", SOFT["configs"] + SOFT["card_configs"],
                         ids=lambda c: c["label"])
def test_fused_prox_trial_matches_plain_on_card(cuda, cfg, dt):
    """The trial entry against its plain twin on the same card inputs:
    one launch, counted under ``fused_prox_stats[trial]`` (and as a
    weighted one with weights) and none under the stats entry; out and the tile nonzeros bit-exact, <d, d>, <d, grad> and
    ||out||^2 within the manifest's rtol.  The same from views one
    element into their storage (the one-element accesses; an even width
    takes 16-byte ones from aligned tensors)."""
    rng = np.random.default_rng(0)
    weighted = bool(cfg.get("weighted"))
    z, _, w = tman.softthresh_problem(cfg, rng, weighted)
    g = rng.standard_normal(z.shape)
    tdt = getattr(torch, dt)
    om, gt = (torch.as_tensor(a, dtype=tdt, device=cuda) for a in (z, g))
    wt = None if w is None else torch.as_tensor(w, dtype=tdt, device=cuda)
    block, alpha = tuple(cfg["block"]), cfg.get("alpha", 0.3)
    want = tref.fused_prox_trial(om, gt, tman.TRIAL_TAU, alpha, weights=wt,
                                 block=block)
    tol = SOFT["rtol"][dt]
    for args in ((om, gt, wt), tuple(_offset(a) for a in (om, gt, wt))):
        tops.reset_launches()
        got = tops.fused_prox_trial(args[0], args[1], tman.TRIAL_TAU, alpha,
                                    weights=args[2], block=block)
        torch.cuda.synchronize()
        assert tops.LAUNCHES["fused_prox_stats[trial]"] == 1
        assert tops.WEIGHTED_LAUNCHES["fused_prox_stats[trial]"] == int(
            weighted)
        assert tops.LAUNCHES["fused_prox_stats"] == 0
        for name, gv, wv in zip(tman.TRIAL_OUTPUTS, got, want):
            assert gv.dtype == wv.dtype and gv.shape == wv.shape, name
            if name in SOFT["exact"]:
                assert torch.equal(gv, wv), name
            else:
                torch.testing.assert_close(gv, wv, rtol=tol, atol=tol,
                                           msg=name)


@pytest.mark.gpu
def test_fused_prox_trial_refusals_on_card(cuda):
    from repro_torch.kernels import softthresh as tst
    om = torch.eye(8, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="grad shape"):
        tops.fused_prox_trial(om, om[:4], 0.5, 0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tst.fused_prox_trial(om.cpu(), om.cpu(), 0.5, 0.1)
    with pytest.raises(TypeError):
        tops.fused_prox_trial(om.half(), om.half(), 0.5, 0.1)


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


#: the f64 tensor-core body's tilings beyond the manifest: ragged M, K
#: and N at bs 128 (zero fill of the 128 x 128 output tile and of the
#: last k-slice), a fully occupied block-row between empty ones (the ring
#: flowing over tile boundaries), the CSR entry at bs 128, a 16384-wide N
#: (the L2 panel order over many column tiles), and odd leading dimensions
#: (the 8-byte copy path)
BSR_TC = (
    {"label": "bs128-ragged-p300-n200", "p": 300, "n": 200, "bs": 128,
     "density": 0.5},
    {"label": "bs128-full-row-between-empty", "p": 640, "n": 256,
     "bs": 128, "rows": "full-middle"},
    {"label": "bs128-csr", "p": 512, "n": 192, "bs": 128, "density": 0.4,
     "csr": True},
    {"label": "bs128-n16384", "p": 256, "n": 16384, "bs": 128,
     "density": 0.75},
    {"label": "bs128-odd-p301-n77", "p": 301, "n": 77, "bs": 128,
     "density": 0.6},
)


def _bsr_tc_problem(cfg, rng):
    """(a, block mask, b) in float64 numpy for a BSR_TC config."""
    p, bs = cfg["p"], cfg["bs"]
    nb = -(-p // bs)
    if cfg.get("rows") == "full-middle":
        keep = np.zeros((nb, nb), bool)
        keep[nb // 2] = True                      # one full block-row
        keep[0, 0] = keep[-1, -1] = True
    else:
        keep = rng.random((nb, nb)) < cfg["density"]
    full = np.repeat(np.repeat(keep, bs, 0), bs, 1)[:p, :p]
    a = np.where(full, rng.standard_normal((p, p)), 0.0)
    return a, keep, rng.standard_normal((p, cfg["n"]))


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", BSR_TC, ids=lambda c: c["label"])
def test_blocksparse_tensor_core_tilings_on_card(cuda, cfg):
    """The f64 body against its plain version and the dense product at
    the manifest's f64 tolerance, one launch per call."""
    a, keep, b = _bsr_tc_problem(cfg, np.random.default_rng(7))
    tol = BSR["rtol"]["float64"]
    at = torch.as_tensor(a, device=cuda)
    bt = torch.as_tensor(b, device=cuda)
    mask = torch.as_tensor(keep.astype(np.int8), device=cuda)
    cap = max(1, int(keep.sum()))
    tops.reset_launches()
    if cfg.get("csr"):
        vals, rows, cols = tref.dense_to_block_csr(a, cfg["bs"])
        got = tops.blocksparse_matmul(torch.as_tensor(vals, device=cuda),
                                      rows, cols, bt)
    else:
        got = tops.masked_matmul(at, bt, mask, block_size=cfg["bs"],
                                 capacity=cap)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["blocksparse_matmul"] == 1
    want = tref.masked_matmul(at, bt, mask, block_size=cfg["bs"],
                              capacity=cap)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    torch.testing.assert_close(got, at @ bt, rtol=tol, atol=tol)


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



FLASH = tman.entry("flash_attention")
F32_BF16 = ("float32", "bfloat16")

#: beyond the manifest: the head dims of the zoo (danube 80, qwen, gemma2
#: and chameleon 128) at ragged lengths, a decode tail, a window without
#: causal, a softcap and GQA 4:1
FLASH_EXTRA = (
    {"label": "danube-d80-ragged", "B": 2, "Hq": 8, "Hkv": 2, "Lq": 200,
     "Lkv": 200, "D": 80, "causal": True, "window": 96},
    {"label": "d128-decode-tail", "B": 1, "Hq": 4, "Hkv": 1, "Lq": 9,
     "Lkv": 301, "D": 128, "causal": True},
    {"label": "d128-window-no-causal", "B": 1, "Hq": 4, "Hkv": 4, "Lq": 130,
     "Lkv": 130, "D": 128, "causal": False, "window": 70},
    {"label": "d128-softcap-gqa", "B": 2, "Hq": 8, "Hkv": 2, "Lq": 77,
     "Lkv": 77, "D": 128, "causal": True, "softcap": 50.0},
    {"label": "d16-full", "B": 1, "Hq": 2, "Hkv": 2, "Lq": 65, "Lkv": 129,
     "D": 16, "causal": False},
    # the wgmma body's tilings: 128-row q tiles and 128-key kv tiles at
    # D 80 (64 at D 128), rows past L zero-filled by TMA
    {"label": "d80-ragged-L333", "B": 1, "Hq": 4, "Hkv": 2, "Lq": 333,
     "Lkv": 333, "D": 80, "causal": True},
    {"label": "d80-window-lt-kv-tile", "B": 1, "Hq": 2, "Hkv": 1, "Lq": 300,
     "Lkv": 300, "D": 80, "causal": True, "window": 48},
    {"label": "d80-decode-lq1", "B": 2, "Hq": 4, "Hkv": 1, "Lq": 1,
     "Lkv": 517, "D": 80, "causal": True, "window": 256},
    {"label": "d128-decode-lq1", "B": 1, "Hq": 2, "Hkv": 2, "Lq": 1,
     "Lkv": 200, "D": 128, "causal": True},
    {"label": "d80-gqa4", "B": 2, "Hq": 8, "Hkv": 2, "Lq": 260, "Lkv": 260,
     "D": 80, "causal": True, "window": 100},
)


def _flash_cases():
    for cfg in (*FLASH["configs"], *FLASH_EXTRA):
        for dt in F32_BF16:
            yield pytest.param(cfg, dt, id=f"{cfg['label']}-{dt}")


@pytest.mark.gpu
@pytest.mark.parametrize("cfg,dt", list(_flash_cases()))
def test_flash_kernel_matches_plain_on_card(cuda, cfg, dt):
    """One launch per call; the output in q's dtype within the manifest's
    tolerance of the plain version on the same card inputs, for
    contiguous inputs, for the (B, H, L, D) views of (B, L, H, D)
    tensors that the model hands over (GQA by head index on strided
    views), and for views one element into their storage (not 16-byte
    aligned: the wrapper copies bf16 ones)."""
    q, k, v, kw = tman.flash_problem(cfg, np.random.default_rng(0))
    tdt = getattr(torch, dt)
    args = [torch.as_tensor(a, dtype=tdt, device=cuda) for a in (q, k, v)]
    want = tref.flash_attention(*args, **kw)
    tol = FLASH["rtol"][dt]
    views = [a.transpose(1, 2).contiguous().transpose(1, 2) for a in args]
    offset = [torch.cat([a.new_zeros(1), a.flatten()])[1:].view(a.shape)
              for a in args]
    assert not any(tfa.aligned16(a) for a in offset)
    for inputs in (args, views, offset):
        tops.reset_launches()
        got = tops.flash_attention(*inputs, **kw)
        torch.cuda.synchronize()
        assert tops.LAUNCHES["flash_attention"] == 1
        assert got.dtype == tdt and got.shape == args[0].shape
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", FLASH["configs"], ids=lambda c: c["label"])
def test_flash_custom_op_counts_visible_pairs_on_card(cuda, cfg):
    """Around a real launch, FlopCounterMode sees the one custom op
    ``repro_torch::flash_attention`` and counts its visible pairs, and
    its fake rule gives the launch's shape and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    q, k, v, kw = tman.flash_problem(cfg, np.random.default_rng(0))
    args = [torch.as_tensor(a, dtype=torch.bfloat16, device=cuda)
            for a in (q, k, v)]
    tops.reset_launches()
    with FlopCounterMode(display=False) as fc:
        got = tops.flash_attention(*args, **kw)
        torch.cuda.synchronize()
    assert tops.LAUNCHES["flash_attention"] == 1
    want = tfa.flops(args[0].shape, args[1].shape, causal=kw["causal"],
                     window=kw["window"])
    assert fc.get_total_flops() == want > 0
    with FakeTensorMode() as mode:
        fake = tops.flash_attention(*(mode.from_tensor(a) for a in args),
                                    **kw)
    assert fake.shape == got.shape and fake.dtype == got.dtype
    assert tops.LAUNCHES["flash_attention"] == 1


@pytest.mark.gpu
def test_flash_kernel_refusals_on_card(cuda, monkeypatch):
    q = torch.zeros((1, 2, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tops.flash_attention(q[..., :12], q[..., :12], q[..., :12])
    strided = torch.zeros((1, 2, 16, 8), device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tops.flash_attention(strided, q, q)
    with pytest.raises(TypeError):
        tops.flash_attention(q.double(), q.double(), q.double())
    # a launch the C side refuses surfaces as an exception, not a result
    monkeypatch.setattr(tfa, "validate", lambda *a: None)
    with pytest.raises(RuntimeError, match="cudaError"):
        tfa.flash_attention(q, q[:, :, :4], q[:, :, :4])


# ---------------------------------------------------------------------------
# the checked build (analysis.kernelpass.kcheck): CA401-CA403 on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", [e["name"] for e in tman.KERNEL_ENTRIES])
def test_checked_build_finds_nothing_in_kernel_on_card(cuda, name):
    """Every seed-0 case of the entry through its checked library: no
    finding, every output element stored exactly once, the outputs
    bit-identical under each jitter seed and within tolerance of the
    plain version."""
    cases = kernelpass.kcheck(seed=0, device=cuda,
                              entries=[tman.entry(name)])
    assert len(cases) == len(kernelfuzz.entry_cases(tman.entry(name)))
    bad = [(c.config, [f.render() for f in c.findings], c.failures)
           for c in cases if not c.ok]
    assert not bad, bad
    assert all(c.worst_count == 1 and c.launches > 0 for c in cases)
    assert all(c.jitter_runs == len(kernelpass.JITTER_SEEDS) for c in cases)
    if name == "fused_prox_stats":
        # two launches of the stats entry and one of the trial entry
        assert all(c.launches == 3 for c in cases)


@pytest.mark.gpu
def test_checked_build_probes_trip_their_rules_on_card(cuda):
    """Each planted fault of csrc/probes/kcheck_faults.cu is reported
    under its rule: the checker is not blind."""
    res = kernelpass.probes(device=cuda)
    assert [(r.probe, r.rule) for r in res] == list(kernelpass.PROBES)
    assert all(r.tripped for r in res), [
        (r.probe, r.rule, [f.render() for f in r.findings]) for r in res]
