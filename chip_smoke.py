#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                 # every phase, one card

Phases, in order; any failure exits non-zero and prints no result line:

  1. device     card name, device count, ``nvidia-smi`` name + power limit
  2. build      nvcc builds ``src/repro_torch/kernels/csrc/*.cu`` for
                sm_90a (one process per source, all at once) and prints
                registers / shared memory / spills per kernel
  3. kernels    each kernel against its plain PyTorch version on the card:
                every config of ``repro_torch/kernels/manifest.py`` (the
                reference's configs; f32 and f64, weighted with inf
                weights at alpha = 0) and the main paths' shapes (the
                path step at C = 3 lanes of p = 16384, both bodies)
  4. main       the Cov solve at p = 16384 (chain graph, n = 8192 samples
                drawn on the card, float64) through ``ConcordEstimator``:
                ``fit_cov`` then a warm-started ``fit_path``; kernel launch
                counts are zeroed before and read after
  5. batched    the batched lambda path on the same S:
                ``fit_path(mode="batched")`` over 3 cold lanes, through the
                fused path-step kernel (one launch per flat step)
  6. adaptive   p = 4096: ``fit_path(adaptive=True)`` batched (stage 2 on
                the path step's weighted body) and sequential (stage 2 on
                the fused prox's weighted body)
  7. obs        one Obs fit at p = 16384, n = 1200
  8. gram       the streaming data path at full size: the banded scenario
                at p = 16384 (cond 10) built on the card, n = 65536 rows
                streamed as float32 ``.npy`` shards into ``build/``, then
                ``launch.gram prep --shards ... --transform standardize``
                (the f64 Gram accumulated on the card), held against a
                one-shot Gram of the same data within 1e-10 of max |S|;
                ``launch.solve --from-gram`` (``--sparse-matmul on``:
                kernel 2) and ``fit_gram`` with ``use_pallas=True``
                (kernels 1 and 2), launch counts zeroed before each and
                read after; the shards are deleted at the end.  Its rank
                part runs ``compute_gram(transform="rank")`` at p = 4096,
                n = 16384: at the main size the rank transform's scratch
                would be 8.6 GB of disk and ~32 sweeps of the source
  9. lm         the LM zoo's loss evaluation at h2o-danube-1.8b's full
                width and depth (24 layers, d 2560, GQA 32/8, head_dim 80,
                window 4096, vocab 32000), random weights from a seeded
                ``torch.Generator``: ``lm.loss_fn`` on 3 batches of
                B = 2, L = 8192 through the flash-attention kernel
  9b. dist      the 1.5D distributed solve (``backend="distributed"``):
                (a) at world size 1 through NCCL on the main S (p = 16384,
                Cov) and its X (Obs), held against ``backend="reference"``
                (equal counts, equal kernel 1 and 2 launches, Omega within
                1e-10 of max |Omega|), with host syncs per trial and peak
                memory; ``torchrun --nproc-per-node 1 -m
                repro_torch.launch.solve --backend distributed`` on a small
                artifact; (b) P_DIST = 4 processes sharing the card over
                gloo at p = 4096 on four grids, each held against the
                single-device solve, each rank's kernels 1 and 2 held
                against their plain versions on its own shard, the watched
                wire bytes against ``comm_volume``, the gloo host copies
  9c. pathmode  the step cost of ``fit_path``'s two modes at p = 16384 with
                the pilot (``costmodel.CARD_STEP_COST``), and the mode
                ``fit_path(mode="auto")`` picks on the card
 10. cross      p = 2048: the kernel path against the dense plain path;
                the batched path through the kernel, on the plain route,
                and as sequential cold solves; the LM's weights cut to 2
                layers at B = 1, L = 8192: the flash route (the kernel)
                against the "ref" route (the plain einsum path)
 11. timing     each kernel body at the main paths' inputs: CUDA-event
                time, plain-version time, library time (kernel 2: the
                dense product and PyTorch's f64 BSR product), and the
                bound

The kernels phase also holds the flash kernel against its plain version
at every manifest config (f32, bf16) and at the LM path's shape (B 2,
Hq 32, Hkv 8, L 8192, D 80, causal, window 4096, bf16).

``--profile`` adds a torch.profiler pass over one warm main-path fit, one
batched path, one prep's streaming pass at the gram phase's size and one
``loss_fn`` at the lm shape (device time by kernel, the card's idle
share); ``--phases`` runs a subset while iterating (e.g. ``--phases
kernels,lm`` or ``--phases gram``).

The second-to-last line is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM data sheet: HBM3 bandwidth and peak rates (dense, no
#: sparsity): float64 on the tensor cores, float32 outside them
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12}

P_MAIN, N_MAIN, N_OBS, P_CROSS, BLOCK = 16384, 8192, 1200, 2048, 128
P_ADAPT, N_ADAPT = 4096, 4096
LAM_PATH = [0.3, 0.2, 0.15]
LANES = len(LAM_PATH)

#: the gram phase: GRAM_FAMILY's scenario at P_GRAM, N_GRAM rows streamed
#: through f32 shards into GRAM_DIR, standardized, solved at LAM_GRAM
#: (final block density well under 0.25, so the sparse branch runs); its
#: rank part at P_RANK x N_RANK
GRAM_FAMILY, GRAM_COND, LAM_GRAM = "banded", 10.0, 0.3
P_GRAM, N_GRAM, P_RANK, N_RANK = 16384, 65536, 4096, 16384
GRAM_DIR = ROOT / "build" / "gram_phase"

#: the dist phase: (a) the main S at world size 1 through NCCL; (b) P_DIST
#: ranks sharing the one card over gloo, at DIST_P x DIST_N, on DIST_GRIDS
#: ((variant, c_x, c_omega)); a small artifact for the torchrun CLI at
#: DIST_CLI_P x DIST_CLI_N
P_DIST, DIST_P, DIST_N = 4, 4096, 4096
DIST_GRIDS = (("cov", 1, 1), ("cov", 2, 2), ("obs", 2, 1), ("obs", 1, 4))
DIST_CLI_P, DIST_CLI_N = 2048, 8192
DIST_DIR = ROOT / "build" / "dist_phase"

#: the LM slice: h2o-danube-1.8b at full width, loss on LM_BATCHES batches
#: of (LM_B, LM_L) tokens; the cross-check cuts it to CROSS_LAYERS layers
LM_ARCH, LM_B, LM_L, LM_BATCHES, CROSS_LAYERS = "h2o_danube_1p8b", 2, 8192, 3, 2
#: the flash kernel's shape on that path: (B, Hq, Hkv, L, D, window)
FLASH_MAIN = (LM_B, 32, 8, LM_L, 80, 4096)
#: the main shape's tolerance beside rtol, in units of each output row's
#: rms: rounding P to bf16 moves an output by ~1.7e-3 of its row's rms
#: (sd), whether the row sees 2 keys or 4096
FLASH_MAIN_ROW_TOL = 3e-2


def phase(name: str):
    print(f"== {name}", flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# phases 1-3
# ---------------------------------------------------------------------------

def device_line(torch) -> tuple[str, int, str]:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {name} (count {count}) torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    return name, count, smi


def build_kernels(build):
    t0 = time.perf_counter()
    libs = build.build()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in build.PTXAS_REPORT.items():
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "smem")):
                print(f"  ptxas[{name}] {line.strip()}")


def _dt(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def compare_prox(torch, ent, ops, ref, z, dm, alpha, w, block):
    """Kernel vs plain version on the same CUDA inputs, at the tolerance
    classes of the manifest entry ``ent``; returns the max abs error of
    ``out`` (0 when bit-exact)."""
    got = ops.fused_prox_stats(z, dm, alpha, weights=w, block=block)
    torch.cuda.synchronize()
    want = ref.fused_prox_stats(z, dm, alpha, weights=w, block=block)
    tol = ent["rtol"][_dt(z.dtype)]
    names = ("out", "logdet", "l1", "sumsq", "min_diag", "block_nnz")
    for nm, g, e in zip(names, got, want):
        if nm in ent["exact"]:
            check(torch.equal(g, e), f"fused prox {nm} is not bit-exact")
        else:
            check(torch.allclose(g, e, rtol=tol, atol=tol),
                  f"fused prox {nm}: {float(g)} vs {float(e)}")
    return float((got[0] - want[0]).abs().max())


def check_kernels(torch, kman, ops, ref, dev):
    """Both kernels against their plain versions at every config of the
    port's kernel manifest (the reference's configs), f64 and f32."""
    soft = kman.entry("fused_prox_stats")
    bsr = kman.entry("blocksparse_matmul")
    rng = np.random.default_rng(0)
    for dtype in (torch.float64, torch.float32):
        for cfg in soft["configs"]:
            z, mask, w = kman.softthresh_problem(cfg, rng,
                                                 bool(cfg.get("weighted")))
            zt = torch.as_tensor(z, dtype=dtype, device=dev)
            wt = None if w is None else torch.as_tensor(w, dtype=dtype,
                                                        device=dev)
            mt = torch.as_tensor(mask, dtype=dtype, device=dev)
            for dm in (mt, None):
                compare_prox(torch, soft, ops, ref, zt, dm,
                             cfg.get("alpha", 0.3), wt, cfg["block"])
        tol = bsr["rtol"][_dt(dtype)]
        for cfg in bsr["configs"]:
            a, vals, rows, cols, b = kman.blocksparse_problem(
                cfg, np.random.default_rng(cfg["seed"]))
            at = torch.as_tensor(a, dtype=dtype, device=dev)
            bt = torch.as_tensor(b, dtype=dtype, device=dev)
            got = ops.blocksparse_matmul(
                torch.as_tensor(vals, dtype=dtype, device=dev),
                torch.as_tensor(rows, device=dev),
                torch.as_tensor(cols, device=dev), bt)
            bs = cfg["bs"]
            mask = (ref.block_nnz(at, (bs, bs)) > 0).to(torch.int8)
            cap = max(1, int(mask.sum()))
            got_m = ops.masked_matmul(at, bt, mask, block_size=bs,
                                      capacity=cap)
            torch.cuda.synchronize()
            want = ref.masked_matmul(at, bt, mask, block_size=bs,
                                     capacity=cap)
            for g in (got, got_m):
                check(torch.allclose(g, want, rtol=tol, atol=tol),
                      f"blocksparse {cfg['label']} {dtype}")
                check(torch.allclose(g, at @ bt, rtol=tol, atol=tol),
                      f"blocksparse {cfg['label']} {dtype} vs dense")
        step = kman.entry("fused_path_step")
        for cfg in step["configs"]:
            for weighted in sorted({False, bool(cfg.get("weighted"))}):
                *args, wts = kman.pathstep_problem(
                    {**cfg, "weighted": weighted}, rng)
                args = [torch.as_tensor(a, dtype=dtype, device=dev)
                        for a in args]
                wt = None if wts is None else torch.as_tensor(
                    wts, dtype=dtype, device=dev)
                compare_step(torch, step, ops, ref, args, wt, cfg["block"])
    print("manifest configs: fused prox, block-sparse and path step agree "
          "(f32, f64, weighted inf at alpha=0, explicit and implicit "
          "diagonal)")


def compare_step(torch, ent, ops, ref, args, weights, block) -> float:
    """The path-step kernel against its plain version on the same CUDA
    inputs: cand bit-exact, the per-lane stats within the manifest's
    rtol; returns the max abs error of cand (0 when bit-exact)."""
    got = ops.fused_path_step(*args, weights=weights, block=block)
    torch.cuda.synchronize()
    want = ref.fused_path_step(*args, weights=weights)
    check(torch.equal(got[0], want[0]), "path step cand is not bit-exact")
    tol = ent["rtol"][_dt(args[0].dtype)]
    check(torch.allclose(got[1], want[1], rtol=tol, atol=tol),
          f"path step stats: {got[1].tolist()} vs {want[1].tolist()}")
    return float((got[0] - want[0]).abs().max())


def path_step_inputs(torch, gen, dev, weighted: bool):
    """C = 3 lanes of p = 16384 in float64: iterates near the identity,
    their products, per-lane (tau, lam1, lam2), and per-lane weights with
    ~1% inf entries (the adaptive path's form)."""
    c, p = LANES, P_MAIN
    om = 0.01 * torch.randn((c, p, p), generator=gen, dtype=torch.float64,
                            device=dev)
    om.diagonal(dim1=-2, dim2=-1).add_(1.0)
    w = 0.1 * torch.randn((c, p, p), generator=gen, dtype=torch.float64,
                          device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    args = [om, w, torch.tensor([1.0, 0.5, 0.25], **f64),
            torch.tensor(LAM_PATH, **f64), torch.full((c,), 0.05, **f64)]
    wts = None
    if weighted:
        wts = torch.rand((c, p, p), generator=gen, **f64).add_(0.1)
        wts.masked_fill_(wts > 1.09, float("inf"))
    return args, wts


def check_kernels_main_shape(torch, kman, ops, ref, dev) -> dict:
    """Both kernels at the main path's shapes against the plain versions."""
    gen = torch.Generator(device=dev).manual_seed(1)
    p, bs = P_MAIN, BLOCK
    z = 0.1 * torch.randn((p, p), generator=gen, dtype=torch.float64,
                          device=dev)
    z.diagonal().add_(1.0)
    err_prox = compare_prox(torch, kman.entry("fused_prox_stats"), ops, ref,
                            z, None, 0.3, None, (bs, bs))
    del z
    nb = p // bs
    keep = torch.rand((nb, nb), generator=gen, device=dev) < 0.03
    keep[::7] = False                         # some empty block-rows
    mask = keep.to(torch.int8)
    a = torch.randn((p, p), generator=gen, dtype=torch.float64, device=dev)
    a *= keep.repeat_interleave(bs, 0).repeat_interleave(bs, 1)
    b = torch.randn((p, p), generator=gen, dtype=torch.float64, device=dev)
    occ = int(keep.sum())
    got = ops.masked_matmul(a, b, mask, block_size=bs, capacity=occ)
    torch.cuda.synchronize()
    want = ref.masked_matmul(a, b, mask, block_size=bs, capacity=occ)
    tol = kman.entry("blocksparse_matmul")["rtol"]["float64"]
    check(torch.allclose(got, want, rtol=tol, atol=tol),
          "block-sparse at the main shape disagrees with the plain version")
    err_bsmm = float((got - want).abs().max())
    print(f"main shapes: fused prox {p}x{p} out bit-exact; block-sparse "
          f"{p}x{p}x{p} at {occ}/{nb * nb} occupied blocks, max abs err "
          f"{err_bsmm:.3e}")
    del a, b, got, want
    errs = {"fused_prox_stats": err_prox, "blocksparse_matmul": err_bsmm}
    z = 0.1 * torch.randn((p, p), generator=gen, dtype=torch.float64,
                          device=dev)
    z.diagonal().add_(1.0)
    wz = torch.rand((p, p), generator=gen, dtype=torch.float64,
                    device=dev).add_(0.1)
    wz.masked_fill_(wz > 1.09, float("inf"))
    errs["fused_prox_stats[weighted]"] = compare_prox(
        torch, kman.entry("fused_prox_stats"), ops, ref, z, None, 0.3, wz,
        (bs, bs))
    del z, wz
    step = kman.entry("fused_path_step")
    for weighted in (False, True):
        torch.cuda.empty_cache()
        args, wts = path_step_inputs(torch, gen, dev, weighted)
        name = "fused_path_step" + ("[weighted]" if weighted else "")
        errs[name] = compare_step(torch, step, ops, ref, args, wts, 256)
        del args, wts
    print(f"main shapes: fused prox {p}x{p} with weights out bit-exact; "
          f"path step {LANES}x{p}x{p}, both bodies, cand bit-exact")
    torch.cuda.empty_cache()
    return errs


def flash_main_inputs(torch, dev, seed: int):
    """q, k, v at the LM path's flash shape in bf16, laid out as the model
    hands them over: (B, H, L, D) views of (B, L, H, D) projections."""
    b, hq, hkv, n, d, _ = FLASH_MAIN
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for h in (hq, hkv, hkv):
        t = torch.randn((b, n, h, d), generator=gen, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
        out.append(t.transpose(1, 2))
    return out


def flash_plain_grouped(torch, ref, q, k, v, **kw):
    """The plain version one (batch, kv head) group at a time, so its
    (L, L) float32 logits stay at one group's 4 heads (1.1 GB)."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    group = q.shape[1] // k.shape[1]
    for b in range(q.shape[0]):
        for g in range(k.shape[1]):
            hs = slice(g * group, (g + 1) * group)
            out[b:b + 1, hs] = ref.flash_attention(
                q[b:b + 1, hs], k[b:b + 1, g:g + 1], v[b:b + 1, g:g + 1],
                **kw)
    return out


def check_flash(torch, kman, ops, ref, dev) -> float:
    """The flash kernel against its plain version at every manifest config
    (f32 and bf16) and at the LM path's shape; returns the main shape's
    max abs error."""
    ent = kman.entry("flash_attention")
    for cfg in ent["configs"]:
        q, k, v, kw = kman.flash_problem(cfg, np.random.default_rng(0))
        for dtype in (torch.float32, torch.bfloat16):
            args = [torch.as_tensor(a, dtype=dtype, device=dev)
                    for a in (q, k, v)]
            got = ops.flash_attention(*args, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention(*args, **kw)
            tol = ent["rtol"][_dt(dtype)]
            check(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol),
                  f"flash {cfg['label']} {dtype}: max abs err "
                  f"{float((got.float() - want.float()).abs().max()):.3e}")
    q, k, v = flash_main_inputs(torch, dev, seed=6)
    kw = dict(causal=True, window=FLASH_MAIN[5], softcap=None)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_plain_grouped(torch, ref, q, k, v, **kw).float()
    diff = (got.float() - want).abs()
    err = float(diff.max())
    # rtol: the manifest's bf16 one (an output ulp at large |out|); the
    # second term scales with the row, as the error of rounding P does
    tol = ent["rtol"]["bfloat16"]
    rms = want.square().mean(-1, keepdim=True).sqrt()
    limit = tol * want.abs() + FLASH_MAIN_ROW_TOL * rms
    used = diff / limit
    worst = int(used.argmax())
    row = worst // q.shape[3] % q.shape[2]
    # what a fixed atol of 1e-3 would have refused, and in which rows
    beyond = diff > tol * want.abs() + 1e-3
    rows_beyond = beyond.any(-1).nonzero()[:, 2]
    last_row = int(rows_beyond.max()) if rows_beyond.numel() else -1
    check(bool(torch.isfinite(got).all()), "flash main shape: non-finite")
    check(bool((diff <= limit).all()),
          f"flash at the main shape: max err {float(used.max()):.3f} of "
          f"the limit (rtol {tol}, {FLASH_MAIN_ROW_TOL} x row rms) at row "
          f"{row}, max abs err {err:.3e}")
    print(f"flash attention: manifest configs agree (f32 at "
          f"{ent['rtol']['float32']}, bf16 at {tol}); main shape "
          f"{tuple(q.shape)} x kv {tuple(k.shape)} bf16 causal window "
          f"{FLASH_MAIN[5]}: max abs err {err:.3e}; worst element "
          f"{float(used.max()):.3f} of its limit (rtol {tol} + "
          f"{FLASH_MAIN_ROW_TOL} x row rms) at row {row}; row rms median "
          f"{float(rms.median()):.3e}; a fixed atol 1e-3 would refuse "
          f"{int(beyond.sum())} values, all in rows <= {last_row}")
    return err


# ---------------------------------------------------------------------------
# the LM slice
# ---------------------------------------------------------------------------

def lm_batches(cfg, n: int, b: int, length: int, seed: int):
    """``n`` (tokens, targets) pairs of (b, length) ids from a numpy seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (n, b, length + 1))
    return [(t[:, :-1], t[:, 1:]) for t in toks]


def lm_path(torch, dev, ops) -> dict:
    """``lm.loss_fn`` at h2o-danube-1.8b's full width and depth on
    LM_BATCHES batches of (LM_B, LM_L) tokens, attention through the flash
    kernel; launch counts zeroed before and read after."""
    from repro_torch import configs
    from repro_torch.models import lm, transformer
    cfg = configs.get(LM_ARCH).with_(attention_impl="flash")
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv}, head_dim {cfg.hd}, window "
          f"{cfg.window}, vocab {cfg.vocab}: {n_params / 1e9:.3f}e9 "
          f"{cfg.param_dtype} parameters drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    check(n_params == cfg.param_count() + 2 * cfg.n_layers * cfg.d_model
          + cfg.d_model, "parameter count differs from the config's")
    batches = [tuple(torch.as_tensor(a, device=dev) for a in bt)
               for bt in lm_batches(cfg, LM_BATCHES, LM_B, LM_L, seed=0)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, walls = [], []
    for tokens, targets in batches:
        t0 = time.perf_counter()
        total, aux = lm.loss_fn(cfg, model, lm.Batch(tokens, targets))
        loss = float(aux["loss"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        check(float(total) == loss, "a decoder's total != its loss")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ln_v = float(np.log(cfg.vocab))
    for i, (loss, wall) in enumerate(zip(losses, walls)):
        print(f"lm batch {i}: loss {loss:.6f} (ln V = {ln_v:.6f}), wall "
              f"{1e3 * wall:.1f} ms, {LM_B * LM_L / wall:.0f} tokens/s")
    print(f"lm: {LM_BATCHES} loss evaluations of {LM_B} x {LM_L} tokens, "
          f"peak {peak / 2**30:.2f} GiB, launches {launches}")
    for loss in losses:
        check(np.isfinite(loss) and abs(loss - ln_v) < 1.0,
              f"loss {loss} is not finite within 1.0 of ln V")
    want = LM_BATCHES * cfg.n_layers
    check(launches["flash_attention"] == want,
          f"flash launches {launches['flash_attention']} != {want}")
    check(peak < 80e9, f"peak memory {peak / 1e9:.1f} GB >= 80 GB")
    return {"cfg": cfg, "model": model, "batches": batches,
            "launches": launches["flash_attention"]}


def cross_check_lm(torch, ops, lm_state):
    """The LM's weights cut to CROSS_LAYERS layers at B = 1, L = 8192 (the
    window of 4096 bites): the loss and final hidden states through the
    flash kernel against the plain einsum route ("ref") on the card."""
    from repro_torch.models import lm, transformer
    cfg0, model = lm_state["cfg"], lm_state["model"]
    tree = model.tree()
    tokens, targets = (t[:1] for t in lm_state["batches"][0])
    out = {}
    for impl in ("flash", "ref"):
        cfg = cfg0.with_(n_layers=CROSS_LAYERS, attention_impl=impl)
        cut = transformer.DecoderLM(cfg, {**tree, "blocks":
                                          tree["blocks"][:CROSS_LAYERS]})
        ops.reset_launches()
        _, aux = lm.loss_fn(cfg, cut, lm.Batch(tokens, targets))
        pc = lm.cast_params(cfg, cut)
        hidden = transformer.forward(
            cfg, pc, tokens, torch.arange(tokens.shape[1],
                                          device=tokens.device))[0]
        torch.cuda.synchronize()
        out[impl] = (float(aux["loss"]), hidden.float(),
                     ops.LAUNCHES["flash_attention"])
        del pc
    (lf, hf, nf), (lr, hr, nr) = out["flash"], out["ref"]
    rel = float((hf - hr).abs().max() / hr.abs().max())
    print(f"cross-check lm {CROSS_LAYERS} layers, 1 x {LM_L}: loss flash "
          f"{lf:.6f} vs ref {lr:.6f} (|d| {abs(lf - lr):.2e}); hidden max "
          f"|d| / max |h| = {rel:.3e}; flash launches {nf} vs {nr}")
    check(nf == 2 * CROSS_LAYERS and nr == 0,
          "cross lm: flash launches are not one per layer and call")
    # bf16 compute: the routes round attention at different points (both
    # round P to bf16 for P V: the ref route its normalised probabilities,
    # the kernel its unnormalised ones, divided by the f32 sum after), a
    # few bf16 ulps (2^-8 relative) over 2 layers
    check(abs(lf - lr) <= 5e-3, "cross lm: losses differ beyond 5e-3")
    check(rel <= 5e-2, "cross lm: hidden states differ beyond 5e-2")


def flash_work(torch) -> tuple[int, int]:
    """(visible (query, key) pairs per head, bytes of q, k, v and out) at
    the LM path's flash shape, causal with its window: what this run's
    masks need, not L^2."""
    b, hq, hkv, n, d, window = FLASH_MAIN
    pos = torch.arange(n, dtype=torch.int64)
    pairs = int((pos - (pos - window + 1).clamp_min(0) + 1).sum())
    nbytes = 2 * (2 * b * hq * n * d + 2 * b * hkv * n * d)
    return pairs, nbytes


def timing_flash(torch, ops, ref, dev) -> dict:
    """The flash kernel at the LM path's shape: CUDA-event ms, the plain
    version's ms (head group by head group), the bound, and
    ``scaled_dot_product_attention`` with the same boolean mask and
    ``enable_gqa=True`` as the library yardstick (timed here only; the
    port never calls it)."""
    b, hq, hkv, n, d, window = FLASH_MAIN
    q, k, v = flash_main_inputs(torch, dev, seed=7)
    kw = dict(causal=True, window=window, softcap=None)
    ms = time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw), 5, 1)
    plain = time_ms(torch, lambda: flash_plain_grouped(
        torch, ref, q, k, v, **kw), 1, 1)
    pos = torch.arange(n, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = time_ms(torch, lambda: sdpa(q, k, v, attn_mask=mask,
                                      scale=d ** -0.5, enable_gqa=True), 3, 1)
    pairs, nbytes = flash_work(torch)
    flops = 4.0 * b * hq * d * pairs
    bnd, by = bound(nbytes, flops, "bfloat16")
    print(f"flash work at {FLASH_MAIN}: {pairs} visible pairs per head, "
          f"{flops:.3e} flops, {nbytes / 1e6:.1f} MB")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib}


def profile_lm(torch, lm_state):
    """Device time by kernel over one ``loss_fn`` at the lm shape, and the
    card's idle share of its wall time."""
    from repro_torch.models import lm
    cfg, model = lm_state["cfg"], lm_state["model"]
    tokens, targets = lm_state["batches"][0]
    _, wall, busy, rows = _profile(
        torch, lambda: lm.loss_fn(cfg, model, lm.Batch(tokens, targets)))
    print(f"profile: loss_fn {LM_B} x {LM_L} wall={wall:.3f} s (profiled), "
          f"device busy {busy:.3f} s, idle share {1.0 - busy / wall:.3f}")
    for secs, n, key in rows[:15]:
        print(f"  {100 * secs / wall:5.1f}% {1e3 * secs:8.2f} ms x{n:<5d} "
              f"{key[:90]}")


# ---------------------------------------------------------------------------
# phases 4-6: the main path
# ---------------------------------------------------------------------------

def support_stats(torch, est, truth, tol=1e-8):
    """PPV and FDR of the estimated off-diagonal support, on the card."""
    e = torch.triu(est.abs() > tol, diagonal=1)
    t = torch.triu(truth != 0, diagonal=1)
    tp, fp = torch.stack([(e & t).sum(), (e & ~t).sum()]).tolist()
    ppv = tp / max(tp + fp, 1)
    return ppv, 1.0 - ppv


def main_path(torch, mods, dev) -> dict:
    graphs, est_mod, penalty, ops = mods
    omega0 = graphs.chain_omega(P_MAIN, dtype=np.float64)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    x = graphs.sample_gaussian_torch(omega0, N_MAIN, gen, dev)
    s = (x.T @ x) / N_MAIN
    del x
    torch.cuda.synchronize()
    print(f"sampled X ({N_MAIN}x{P_MAIN}) and S on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    truth = torch.as_tensor(omega0, device=dev)
    cfg = est_mod.SolverConfig(backend="reference", variant="cov",
                               use_pallas=True, sparse_matmul="on",
                               dtype="float64")
    est = est_mod.ConcordEstimator(penalty=penalty.PenaltySpec.l1(0.3, 0.05),
                                   config=cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    est.fit_cov(s, n_samples=N_MAIN)
    wall = time.perf_counter() - t0
    rep = est.report_
    launches_fit = dict(ops.LAUNCHES)
    print(rep.summary())
    ppv, fdr = support_stats(torch, rep.omega, truth)
    print(f"fit_cov: iters={rep.iters} trials={rep.ls_total} "
          f"wall={wall:.2f} s ({1e3 * rep.wall_time_s / rep.ls_total:.1f} "
          f"ms/trial) peak={torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB PPV={ppv:.4f} FDR={fdr:.4f} launches={launches_fit}")
    check(rep.converged and not rep.stalled, "main fit did not converge")
    check(rep.block_density < 0.25,
          f"final block density {rep.block_density} >= 0.25")
    check(launches_fit["fused_prox_stats"] == rep.ls_total,
          "fused prox launches != line-search trials")
    check(launches_fit["blocksparse_matmul"] > 0,
          "the block-sparse kernel never ran on the main path")
    check(bool(torch.isfinite(rep.omega).all()), "non-finite estimate")

    t0 = time.perf_counter()
    path = est.fit_path(s=s, lam1_grid=LAM_PATH, n_samples=N_MAIN)
    pwall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    best = path.best_bic()
    print(path.summary())
    print(f"fit_path: {len(path)} points, iters={path.total_iters} "
          f"trials={path.total_ls} wall={pwall:.2f} s, BIC picks "
          f"lam1={best.lam1} peak={torch.cuda.max_memory_allocated() / 2**30:.1f}"
          f" GiB launches={launches}")
    for r in path:
        check(r.converged and not r.stalled, f"path point {r.lam1} failed")
        check(r.block_density < 0.25, f"path point {r.lam1} is dense")
    check(launches["fused_prox_stats"] == rep.ls_total + path.total_ls,
          "fused prox launches != line-search trials along the path")
    ppv, fdr = support_stats(torch, best.omega, truth)
    print(f"BIC choice lam1={best.lam1}: PPV={ppv:.4f} FDR={fdr:.4f}")
    return {"launches": launches, "omega": rep.omega, "s": s,
            "truth": truth, "lam1": 0.3, "lam2": 0.05}


def batched_config(est_mod, use_pallas: bool = True, **kw):
    return est_mod.SolverConfig(backend="reference", variant="cov",
                                use_pallas=use_pallas, dtype="float64",
                                **kw)


def batched_path(torch, mods, state) -> dict:
    """The whole lam1 grid in lock step at p = 16384 on the main path's S:
    every flat step is one path-step launch for all live lanes plus one
    GEMM per live lane."""
    _, est_mod, penalty, ops = mods
    est = est_mod.ConcordEstimator(penalty=penalty.PenaltySpec.l1(0.3, 0.05),
                                   config=batched_config(est_mod))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    path = est.fit_path(s=state["s"], lam1_grid=LAM_PATH, n_samples=N_MAIN,
                        mode="batched")
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    st = path.batch_stats
    steps = len(st.capacities)
    print(path.summary())
    best = path.best_bic()
    ppv, fdr = support_stats(torch, best.omega, state["truth"])
    print(f"batched path: {len(path)} lanes, {steps} flat steps in "
          f"{st.segments} segments, lane trials {st.lane_steps}, engine "
          f"{path.wall_time_s:.2f} s ({1e3 * path.wall_time_s / steps:.1f} "
          f"ms/flat step), fit_path {wall:.2f} s with BIC; host syncs "
          f"{steps + st.segments} ({steps} flat steps + {st.segments} "
          f"harvests); peak {peak / 2**30:.1f} GiB; launches {launches}; "
          f"BIC picks lam1={best.lam1} PPV={ppv:.4f} FDR={fdr:.4f}")
    check(path.mode == "batched", "fit_path did not run batched")
    for r in path:
        check(r.converged and not r.stalled, f"lane {r.lam1} failed")
    check(launches["fused_path_step"] == steps,
          "path-step launches != executed flat steps")
    check(peak < 80e9, f"peak memory {peak / 1e9:.1f} GB >= 80 GB")
    return {"launches": launches["fused_path_step"]}


def adaptive_paths(torch, mods, dev) -> dict:
    """The two-stage adaptive lasso at p = 4096, batched (stage 2 through
    the path step's weighted body) and sequential (stage 2 through the
    fused prox's weighted body)."""
    graphs, est_mod, penalty, ops = mods
    gen = torch.Generator(device=dev).manual_seed(4)
    x = graphs.sample_gaussian_torch(
        graphs.chain_omega(P_ADAPT, dtype=np.float64), N_ADAPT, gen, dev)
    s = (x.T @ x) / N_ADAPT
    del x
    out = {}
    for mode in ("batched", "sequential"):
        sparse = "on" if mode == "sequential" else "off"
        est = est_mod.ConcordEstimator(
            penalty=penalty.PenaltySpec.l1(0.3, 0.05),
            config=batched_config(est_mod, sparse_matmul=sparse))
        ops.reset_launches()
        t0 = time.perf_counter()
        path = est.fit_path(s=s, lam1_grid=LAM_PATH, n_samples=N_ADAPT,
                            mode=mode, adaptive=True)
        wall = time.perf_counter() - t0
        launches, weighted = dict(ops.LAUNCHES), dict(ops.WEIGHTED_LAUNCHES)
        print(f"adaptive {mode} p={P_ADAPT}: stage 1 iters "
              f"{[r.iters for r in path.stage1]}, stage 2 iters "
              f"{[r.iters for r in path]} trials {[r.ls_total for r in path]}"
              f", {wall:.2f} s, BIC picks lam1={path.best_bic().lam1}; "
              f"launches {launches}, weighted {weighted}")
        check(path.adaptive and path.mode == mode, "not an adaptive path")
        for r in (*path.stage1, *path):
            check(r.converged and not r.stalled,
                  f"adaptive {mode} lam1={r.lam1} ({r.penalty}) failed")
        if mode == "batched":
            s1 = len(path.stage1.batch_stats.capacities)
            s2 = len(path.batch_stats.capacities)
            check(weighted["fused_path_step"] == s2 > 0,
                  "weighted path-step launches != stage-2 flat steps")
            check(launches["fused_path_step"] == s1 + s2,
                  "path-step launches != flat steps of both stages")
            out["fused_path_step[weighted]"] = s2
        else:
            t2 = path.total_ls
            check(weighted["fused_prox_stats"] == t2 > 0,
                  "weighted fused-prox launches != stage-2 trials")
            check(launches["fused_prox_stats"] == path.stage1.total_ls + t2,
                  "fused-prox launches != trials of both stages")
            out["fused_prox_stats[weighted]"] = t2
    return out


def obs_fit(torch, mods, dev):
    graphs, est_mod, penalty, ops = mods
    omega0 = graphs.chain_omega(P_MAIN, dtype=np.float64)
    gen = torch.Generator(device=dev).manual_seed(2)
    x = graphs.sample_gaussian_torch(omega0, N_OBS, gen, dev)
    cfg = est_mod.SolverConfig(backend="reference", variant="obs",
                               use_pallas=True, sparse_matmul="on",
                               dtype="float64")
    est = est_mod.ConcordEstimator(penalty=penalty.PenaltySpec.l1(0.3, 0.05),
                                   config=cfg)
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    est.fit(x)
    rep = est.report_
    print(rep.summary())
    print(f"obs fit: p={P_MAIN} n={N_OBS} launches={dict(ops.LAUNCHES)} "
          f"peak={torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    check(rep.converged and not rep.stalled, "obs fit did not converge")
    check(ops.LAUNCHES["fused_prox_stats"] == rep.ls_total,
          "obs: fused prox launches != trials")
    check(ops.LAUNCHES["blocksparse_matmul"] > 0,
          "obs: the block-sparse kernel never ran")


def one_shot_gram(torch, shard_dir: Path, n: int, p: int, dev):
    """The standardized Gram of the shards' f32 data cast to f64, in one
    product on the card: centered first, scaled after (the streamed
    Gram applies the same transform algebraically to raw moments)."""
    x = torch.empty((n, p), dtype=torch.float64, device=dev)
    row = 0
    for path in sorted(shard_dir.glob("*.npy")):
        part = torch.from_numpy(np.load(path)).to(dev)
        x[row:row + part.shape[0]] = part
        row += part.shape[0]
    check(row == n, f"the shards hold {row} rows, not {n}")
    x -= x.mean(dim=0)
    s = (x.T @ x).div_(n)
    del x
    sd = s.diagonal().sqrt()
    sd = torch.where(sd < 1e-12, torch.ones_like(sd), sd)
    return s.div_(sd[:, None]).div_(sd[None, :])


def gram_path(torch, mods, dev, profile: bool) -> None:
    """The streaming data path at full size: scenario -> f32 shards ->
    ``launch.gram prep`` -> ``launch.solve --from-gram`` and ``fit_gram``;
    then the rank transform at P_RANK x N_RANK."""
    from repro_torch.core.costmodel import gram_chunk_rows
    from repro_torch.data import (compute_gram, make_scenario, open_shards,
                                  write_shards)
    from repro_torch.data.shards import CallableSource
    from repro_torch.launch import gram as gram_cli
    from repro_torch.launch import solve as solve_cli
    _, est_mod, _, ops = mods
    shard_dir, art = GRAM_DIR / "shards", GRAM_DIR / "artifact"
    shutil.rmtree(GRAM_DIR, ignore_errors=True)
    walls, peaks = {}, {}

    def timed(name, fn):
        """Run one part: host wall (ends in a sync) and its own peak
        device memory (``max_memory_allocated`` reset before it)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        peaks[name] = torch.cuda.max_memory_allocated()
        return out

    try:
        sc = timed("scenario (weights, eigvalsh)", lambda: make_scenario(
            GRAM_FAMILY, P_GRAM, seed=0, cond=GRAM_COND, device=dev))
        timed("cholesky (alone)", lambda: torch.linalg.cholesky(sc.omega))
        rows = gram_chunk_rows(P_GRAM)

        def write():
            src = sc.source(N_GRAM, chunk_rows=rows, seed=1)
            for i, x in enumerate(src.chunks()):
                write_shards(x.float(), shard_dir, rows_per_shard=rows,
                             prefix=f"shard{i:03d}")
        timed("shards (draws, solves, f32 .npy)", write)
        shard_bytes = sum(f.stat().st_size for f in shard_dir.iterdir())
        argv = ["prep", "--shards", str(shard_dir), "--transform",
                "standardize", "--out", str(art)]
        timed("prep (CLI)", lambda: gram_cli.main(argv))
        meta = json.loads((art / gram_cli.META_NAME).read_text())
        print(f"gram prep: n={meta['n']} p={meta['p']} {meta['n_chunks']} "
              f"chunks of <= {meta['chunk_rows']} rows from "
              f"{shard_bytes / 1e9:.2f} GB of {meta['source_dtype']} "
              f"shards; stream {meta['wall_time_s']} s, "
              f"{meta['rows_per_s']} rows/s; peak_bytes_streamed "
              f"{meta['peak_bytes_streamed'] / 1e9:.2f} GB vs "
              f"peak_bytes_dense {meta['peak_bytes_dense'] / 1e9:.2f} GB")
        check(meta["n"] == N_GRAM and meta["p"] == P_GRAM
              and meta["source_dtype"] == "float32", "prep metadata")
        if profile:
            profile_prep(torch, compute_gram, open_shards, shard_dir,
                         meta["chunk_rows"], dev)
        one = timed("one-shot Gram (check)", lambda: one_shot_gram(
            torch, shard_dir, N_GRAM, P_GRAM, dev))
        gram = gram_cli.load_gram(str(art), device=dev)
        scale = float(one.abs().max())
        err = float((gram.s - one).abs().max())
        del one
        print(f"streamed vs one-shot Gram: max |dS| {err:.3e}, max |S| "
              f"{scale:.3e} ({err / scale:.3e} of it)")
        check(err <= 1e-10 * scale, "the streamed Gram disagrees with the "
              "one-shot Gram beyond 1e-10 of max |S|")
        check(float((gram.s.diagonal() - 1).abs().max()) <= 1e-12,
              "the standardized Gram has no unit diagonal")
        del gram

        ops.reset_launches()
        rep_cli = timed("solve (CLI --from-gram)", lambda: solve_cli.main([
            "--from-gram", str(art), "--lam1", str(LAM_GRAM), "--backend",
            "reference", "--sparse-matmul", "on"]))
        l_cli = dict(ops.LAUNCHES)
        cfg = est_mod.SolverConfig(backend="reference", variant="cov",
                                   use_pallas=True, sparse_matmul="on",
                                   dtype="float64")
        est = est_mod.ConcordEstimator(lam1=LAM_GRAM, lam2=0.05, config=cfg)
        gram = gram_cli.load_gram(str(art), device=dev)
        ops.reset_launches()
        timed("solve (fit_gram)", lambda: est.fit_gram(gram))
        l_fit = dict(ops.LAUNCHES)
        rep = est.report_
        print(f"launch.solve --from-gram: iters={rep_cli.iters} trials="
              f"{rep_cli.ls_total} density={rep_cli.block_density:.4f} "
              f"launches={l_cli}")
        print(f"fit_gram (use_pallas): iters={rep.iters} trials="
              f"{rep.ls_total} density={rep.block_density:.4f} "
              f"launches={l_fit}; max |dOmega| vs the CLI's "
              f"{float((rep.omega - rep_cli.omega).abs().max()):.3e}")
        for name, r, launches in (("launch.solve", rep_cli, l_cli),
                                  ("fit_gram", rep, l_fit)):
            check(r.converged and not r.stalled, f"{name} did not converge")
            check(r.block_density < 0.25,
                  f"{name}: final block density {r.block_density} >= 0.25")
            check(launches["blocksparse_matmul"] > 0,
                  f"{name}: the block-sparse kernel never ran")
            check(bool(torch.isfinite(r.omega).all()),
                  f"{name}: non-finite estimate")
        check(l_fit["fused_prox_stats"] == rep.ls_total,
              "fit_gram: fused prox launches != line-search trials")
        ppv, fdr = support_stats(torch, rep.omega, sc.omega)
        print(f"gram phase: PPV={ppv:.4f} FDR={fdr:.4f} vs the scenario's "
              f"Omega")
        del gram, est, rep, rep_cli, sc
        torch.cuda.empty_cache()

        # the rank part, cut to P_RANK x N_RANK
        sc = make_scenario(GRAM_FAMILY, P_RANK, seed=0, cond=GRAM_COND,
                           device=dev)
        src = sc.source(N_RANK, chunk_rows=4096, seed=1)

        def distorted():
            for c in src.chunks():
                c = c.clone()
                c[:, 0] = torch.exp(c[:, 0])
                yield c
        g0 = timed("rank Gram", lambda: compute_gram(
            src, transform="rank", device=dev, scratch_dir=str(GRAM_DIR)))
        g1 = compute_gram(CallableSource(distorted, p=P_RANK, n_rows=N_RANK),
                          transform="rank", device=dev,
                          scratch_dir=str(GRAM_DIR))
        diag = float((g0.s.diagonal() - 1).abs().max())
        moved = float((g1.s - g0.s).abs().max())
        print(f"rank Gram p={P_RANK} n={N_RANK}: max |diag - 1| {diag:.3e}; "
              f"exp() of column 0 moves it by {moved:.3e}")
        check(diag <= 1e-10, "the rank Gram has no unit diagonal")
        check(moved <= 1e-10, "the rank Gram moved under a monotone "
              "distortion of one column")
        for name, secs in walls.items():
            print(f"gram part: {name} wall {secs:.2f} s, peak "
                  f"{peaks[name] / 2**30:.1f} GiB (max_memory_allocated)")
        print(f"gram phase peak {max(peaks.values()) / 2**30:.1f} GiB")
    finally:
        shutil.rmtree(GRAM_DIR, ignore_errors=True)


def profile_prep(torch, compute_gram, open_shards, shard_dir, rows, dev):
    """Device time by kernel over one prep's streaming pass (the f64 GEMM
    slabs, the H2D copies, the casts and the Welford passes), and the
    card's idle share of its wall time."""
    _, wall, busy, rows_ = _profile(torch, lambda: compute_gram(
        open_shards(str(shard_dir), chunk_rows=rows),
        transform="standardize", device=dev))
    print(f"profile: prep stream n={N_GRAM} p={P_GRAM} wall={wall:.3f} s "
          f"(profiled), device busy {busy:.3f} s, idle share "
          f"{1.0 - busy / wall:.3f}")
    for secs, n, key in rows_[:12]:
        print(f"  {100 * secs / wall:5.1f}% {1e3 * secs:9.2f} ms x{n:<5d} "
              f"{key[:90]}")
    # the host side alone: the shards' bytes read with plain buffered
    # reads, and copied out of the memmap views the stream hands over
    paths = sorted(shard_dir.glob("*.npy"))
    nbytes = sum(p.stat().st_size for p in paths)
    buf = bytearray(max(p.stat().st_size for p in paths))
    t0 = time.perf_counter()
    for path in paths:
        with open(path, "rb", buffering=0) as f:
            while f.readinto(memoryview(buf)[:len(buf)]):
                pass
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    for chunk in open_shards(str(shard_dir), chunk_rows=rows).chunks():
        np.array(chunk)
    t_copy = time.perf_counter() - t0
    print(f"profile: host reads of the {nbytes / 1e9:.2f} GB of shards: "
          f"readinto {t_read:.2f} s ({nbytes / t_read / 1e9:.2f} GB/s), "
          f"memmap copy {t_copy:.2f} s ({nbytes / t_copy / 1e9:.2f} GB/s)")
    # host time by function over one more streaming pass
    import cProfile
    import io
    import pstats
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(lambda: compute_gram(open_shards(str(shard_dir),
                                                  chunk_rows=rows),
                                      transform="standardize", device=dev))
    torch.cuda.synchronize()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(8)
    print(f"profile: host time by function over one more pass "
          f"({time.perf_counter() - t0:.2f} s):")
    for line in out.getvalue().splitlines():
        if line.strip() and line.lstrip()[0].isdigit():
            print(f"  {line.strip()[:110]}")


def cross_check(torch, mods, dev):
    graphs, est_mod, penalty, ops = mods
    omega0 = graphs.chain_omega(P_CROSS, dtype=np.float64)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = graphs.sample_gaussian_torch(omega0, 4096, gen, dev)
    s = (x.T @ x) / x.shape[0]
    reps = []
    for kern in (True, False):
        cfg = est_mod.SolverConfig(
            backend="reference", variant="cov", use_pallas=kern,
            sparse_matmul="on" if kern else "off", dtype="float64")
        est = est_mod.ConcordEstimator(
            penalty=penalty.PenaltySpec.l1(0.3, 0.05), config=cfg)
        reps.append(est.fit_cov(s, n_samples=4096).report_)
    a, b = reps
    err = float((a.omega - b.omega).abs().max())
    print(f"cross-check p={P_CROSS}: kernels iters={a.iters} "
          f"trials={a.ls_total} vs plain dense iters={b.iters} "
          f"trials={b.ls_total}; max |dOmega| = {err:.3e}")
    check((a.iters, a.ls_total) == (b.iters, b.ls_total),
          "kernel and plain paths took different iterations")
    check(err <= 1e-10, "kernel and plain paths disagree beyond 1e-10")

    # the batched path: kernel route, plain route, sequential cold solves
    runs = {}
    for name, kern in (("kernel", True), ("plain", False)):
        est = est_mod.ConcordEstimator(
            penalty=penalty.PenaltySpec.l1(0.3, 0.05),
            config=batched_config(est_mod, use_pallas=kern))
        ops.reset_launches()
        runs[name] = est.fit_path(s=s, lam1_grid=LAM_PATH, n_samples=4096,
                                  mode="batched", score_bic=False)
        steps = len(runs[name].batch_stats.capacities)
        check(ops.LAUNCHES["fused_path_step"] == (steps if kern else 0),
              f"cross {name}: path-step launches != flat steps")
    est = est_mod.ConcordEstimator(penalty=penalty.PenaltySpec.l1(0.3, 0.05),
                                   config=batched_config(est_mod, False))
    runs["sequential"] = est.fit_path(s=s, lam1_grid=LAM_PATH,
                                      n_samples=4096, warm_start=False,
                                      score_bic=False)
    counts = {k: [(r.iters, r.ls_total) for r in v] for k, v in runs.items()}
    errs = {k: max(float((r.omega - q.omega).abs().max())
                   for r, q in zip(runs[k], runs["sequential"]))
            for k in ("kernel", "plain")}
    print(f"cross-check batched p={P_CROSS}: (iters, trials) per lane "
          f"{counts}; max |dOmega| vs sequential {errs}")
    check(counts["kernel"] == counts["plain"] == counts["sequential"],
          "batched kernel / plain / sequential lanes took different "
          "iterations")
    check(max(errs.values()) <= 1e-9,
          "batched lanes disagree with sequential solves beyond 1e-9")


# ---------------------------------------------------------------------------
# the dist phase: the 1.5D distributed solve
# ---------------------------------------------------------------------------

def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def count_syncs(torch, fn):
    """(fn(), device->host syncs it made), from CUDA's sync debug mode."""
    import warnings
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def dist_solve_config(est_mod, backend: str, variant: str):
    return est_mod.SolverConfig(backend=backend, variant=variant,
                                use_pallas=True, sparse_matmul="on",
                                dtype="float64")


def dist_world1(torch, mods, dev, profile: bool) -> None:
    """(a) The main S (Cov) and its X (Obs) at p = 16384 through
    ``backend="distributed"`` on a one-rank NCCL group, each held against
    ``backend="reference"`` on the card; with ``profile``, device time by
    kernel of one warm distributed fit of each."""
    from repro_torch.comm import Grid1p5D, comm_for, group
    graphs, est_mod, penalty, ops = mods
    gen = torch.Generator(device=dev).manual_seed(0)
    x = graphs.sample_gaussian_torch(
        graphs.chain_omega(P_MAIN, dtype=np.float64), N_MAIN, gen, dev)
    s = (x.T @ x) / N_MAIN
    group.init_process_group(dev, world_size=1, rank=0,
                             init_method=f"tcp://localhost:{free_port()}")
    try:
        for variant, data in (("cov", dict(s=s, n_samples=N_MAIN)),
                              ("obs", dict(x=x))):
            runs = {}
            for backend in ("reference", "distributed"):
                est = est_mod.ConcordEstimator(
                    penalty=penalty.PenaltySpec.l1(0.3, 0.05),
                    config=dist_solve_config(est_mod, backend, variant))
                fit = est.fit_cov if variant == "cov" else est.fit
                args = (s,) if variant == "cov" else (x,)
                kw = dict(n_samples=N_MAIN) if variant == "cov" else {}
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launches()
                t0 = time.perf_counter()
                rep = fit(*args, **kw).report_
                first = time.perf_counter() - t0
                launches = dict(ops.LAUNCHES)
                peak = torch.cuda.max_memory_allocated()
                t0 = time.perf_counter()
                warm = fit(*args, **kw).report_
                wall = time.perf_counter() - t0
                check((warm.iters, warm.ls_total) == (rep.iters, rep.ls_total),
                      f"dist {variant} {backend}: a second fit took other "
                      f"counts")
                _, syncs = count_syncs(torch, lambda: fit(*args, **kw))
                runs[backend] = (rep, launches, wall, peak, syncs)
                if profile and backend == "distributed":
                    _, pw, busy, rows = _profile(
                        torch, lambda: fit(*args, **kw))
                    print(f"profile: distributed {variant} at world size 1 "
                          f"wall={pw:.3f} s (profiled), device busy "
                          f"{busy:.3f} s, idle share {1.0 - busy / pw:.3f}")
                    for secs, cnt, key in rows[:12]:
                        print(f"  {100 * secs / pw:5.1f}% "
                              f"{1e3 * secs / rep.ls_total:7.3f} ms/trial "
                              f"x{cnt:<5d} {key[:90]}")
                print(f"dist world 1 {variant} {backend}: iters={rep.iters} "
                      f"trials={rep.ls_total} first call {first:.3f} s, warm "
                      f"{wall:.3f} s ({1e3 * warm.wall_time_s / rep.ls_total:.1f}"
                      f" ms/trial) host syncs {syncs} ({syncs / rep.ls_total:.2f}"
                      f" per trial) peak={peak / 2**30:.1f} GiB launches="
                      f"{launches} density={rep.block_density:.4f}")
            (a, la, *_), (b, lb, *_) = runs["reference"], runs["distributed"]
            scale = float(a.omega.abs().max())
            err = float((a.omega - b.omega).abs().max())
            comm = comm_for(Grid1p5D(1, 1, 1), b.omega.device)
            print(f"dist world 1 {variant}: max |dOmega| {err:.3e} of max "
                  f"|Omega| {scale:.3e}; {b.backend} on {comm.backend}, "
                  f"grid {b.n_devices}x({b.c_x},{b.c_omega}); collectives "
                  f"through {comm.backend} so far {dict(comm.calls)}, host "
                  f"copies {comm.host_copies}")
            check(b.backend == "distributed" and comm.backend == "nccl",
                  f"dist {variant}: not the distributed backend on NCCL")
            check((a.iters, a.ls_total) == (b.iters, b.ls_total),
                  f"dist {variant}: counts differ from the reference "
                  f"backend's")
            check(err <= 1e-10 * scale, f"dist {variant}: Omega differs "
                  f"beyond 1e-10 of max |Omega|")
            check(b.converged and not b.stalled, f"dist {variant}: no "
                  f"convergence")
            check(lb["fused_prox_stats"] == b.ls_total > 0
                  and lb["blocksparse_matmul"] > 0,
                  f"dist {variant}: kernels 1 and 2 did not run per trial")
            check(la == lb, f"dist {variant}: launches {lb} differ from the "
                  f"reference backend's {la}")
            check(comm.host_copies == 0 and sum(comm.calls.values()) > 0,
                  f"dist {variant}: no NCCL collective, or a host copy")
    finally:
        group.destroy_process_group()
    del x, s
    torch.cuda.empty_cache()


def dist_cli(torch, mods, dev) -> None:
    """``torchrun --nproc-per-node 1 -m repro_torch.launch.solve --backend
    distributed`` on a small artifact this phase writes, against the same
    CLI at ``--backend reference`` in this process."""
    import re
    import os
    from repro_torch.launch import gram as gram_cli
    from repro_torch.launch import solve as solve_cli
    _, _, _, ops = mods
    art = DIST_DIR / "artifact"
    gram_cli.main(["prep", "--scenario", "banded", "--p", str(DIST_CLI_P),
                   "--n", str(DIST_CLI_N), "--out", str(art)])
    argv = ["--from-gram", str(art), "--lam1", "0.3", "--sparse-matmul",
            "on"]
    ops.reset_launches()
    want = solve_cli.main(argv + ["--backend", "reference"])
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "repro_torch.launch.solve", *argv,
           "--backend", "distributed"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    wall = time.perf_counter() - t0
    out = proc.stdout.strip().splitlines()
    line = next((ln for ln in out if ln.startswith("[distributed/")), "")
    print(f"torchrun CLI (exit {proc.returncode}, {wall:.1f} s with start-"
          f"up): {line}")
    check(proc.returncode == 0, f"torchrun CLI failed:\n{proc.stderr[-3000:]}")
    m = re.search(r"iters=(\d+) ls=(\d+)", line)
    check(m is not None and (int(m[1]), int(m[2])) == (want.iters,
                                                       want.ls_total),
          f"torchrun CLI counts differ from --backend reference's "
          f"({want.iters}, {want.ls_total})")
    print(f"launch.solve --backend reference: iters={want.iters} "
          f"trials={want.ls_total}")


def _dist_rank(rank, cfg, out_q):
    """One of ``cfg["world"]`` ranks sharing ``cfg["device"]`` over gloo:
    the distributed solves of ``cfg["grids"]`` on the X and S the parent
    saved, each rank's kernels on its own shard, the wire bytes of one
    product of each solve."""
    import datetime
    import traceback
    sys.path.insert(0, str(SRC))
    import torch
    from repro_torch.comm import Grid1p5D, comm_for, group
    from repro_torch.comm import matmul1p5d as mm
    from repro_torch.comm import sparse1p5d as sp
    from repro_torch.comm.group import set_collective_watcher
    from repro_torch.core import distributed as dist
    from repro_torch.core import graphs, matops
    from repro_torch.core.costmodel import comm_volume
    from repro_torch.kernels import manifest as kman
    from repro_torch.kernels import ops, ref
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        world, bs = cfg["world"], cfg["block"]
        dev = group.init_process_group(
            cfg["device"], backend="gloo", world_size=world, rank=rank,
            init_method=f"file://{cfg['init_file']}",
            timeout=datetime.timedelta(seconds=300))
        data = torch.load(cfg["data"], map_location=dev)
        x, s = data["x"], data["s"]
        n, p = x.shape
        pol = matops.MatmulPolicy("on", bs, 0.25)
        out = []
        for variant, cx, co in cfg["grids"]:
            grid = Grid1p5D(world, cx, co)
            comm = comm_for(grid, dev)
            copies0 = comm.host_copies
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit = dist.fit_cov if variant == "cov" else dist.fit_obs
            res = fit(s if variant == "cov" else x, 0.3, 0.05, grid=grid,
                      use_pallas=True, sparse_matmul=pol)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            copies = comm.host_copies - copies0
            want = torch.load(cfg[variant], map_location=dev)
            err = float((res.omega - want["omega"]).abs().max())
            scale = float(want["omega"].abs().max())
            # kernels 1 and 2 on this rank's shard, against plain versions
            layout = mm.SPEC_XCOL if variant == "cov" else mm.SPEC_OM
            om = mm.shard(res.omega, comm, layout)
            if variant == "cov":
                blk, lo = p // grid.n_x, comm.block_x
                dm = torch.zeros_like(om)
                dm[lo * blk:(lo + 1) * blk].diagonal().fill_(1.0)
                a = om.T.contiguous()
                b = mm.shard(s, comm, mm.SPEC_XCOL)
            else:
                blk, lo = p // grid.n_om, comm.block_om
                dm = torch.zeros_like(om)
                dm[:, lo * blk:(lo + 1) * blk].diagonal().fill_(1.0)
                bx = p // grid.n_x
                a = om[:, :bx].contiguous()
                b = mm.shard(x, comm, mm.SPEC_XCOL).T.contiguous()[:bx]
            gen = torch.Generator(device=dev).manual_seed(rank)
            z = om + 0.01 * torch.randn(om.shape, generator=gen,
                                        dtype=om.dtype, device=dev)
            err1 = compare_prox(torch, kman.entry("fused_prox_stats"), ops,
                                ref, z, dm, 0.03, None, (bs, bs))
            mask = matops.block_mask(a, bs)
            occ = max(1, int((mask > 0).sum()))
            got = ops.masked_matmul(a, b, mask, block_size=bs, capacity=occ)
            torch.cuda.synchronize()
            plain = ref.masked_matmul(a, b, mask, block_size=bs,
                                      capacity=occ)
            tol = kman.entry("blocksparse_matmul")["rtol"]["float64"]
            err2 = float((got - plain).abs().max())
            if not torch.allclose(got, plain, rtol=tol, atol=tol):
                raise AssertionError(f"rank {rank} kernel 2 on its shard "
                                     f"{tuple(a.shape)}: {err2:.3e}")
            # the wire bytes of one product of this solve's schedule
            events = []
            prev = set_collective_watcher(
                lambda prim, axes, nb: events.append(nb))
            try:
                m = matops.block_mask(om, bs)
                if variant == "cov":
                    sp.omega_s_local_sparse(om.T, m.T, b, comm,
                                            canonical="xlike", policy=pol)
                    vol = comm_volume(p, n, world, cx, co, flavor="omega_s",
                                      canonical="xlike", masked=True,
                                      block_size=bs)
                else:
                    xt = mm.shard(x, comm, mm.SPEC_XCOL).T
                    sp.omega_xt_local_sparse(om, m, xt, comm, policy=pol)
                    vol = comm_volume(p, n, world, cx, co, flavor="omega_xt")
            finally:
                set_collective_watcher(prev)
            out.append(dict(
                variant=variant, grid=(cx, co), iters=res.iters,
                trials=res.ls_total, converged=res.converged,
                stalled=res.stalled, err=err, scale=scale,
                want=(want["iters"], want["ls_total"]), wall=wall,
                launches=launches, host_copies=copies, err1=err1,
                err2=err2, shard=tuple(om.shape), tile=(tuple(a.shape),
                                                        tuple(b.shape)),
                occupied=occ, bytes=str(sum(events)), volume=str(vol.total),
                density=res.block_density))
        out_q.put((rank, True, out))
    except BaseException:
        out_q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        group.destroy_process_group()


def dist_problem(torch, graphs, dev):
    """The (b) problem, drawn alike on every rank: X (DIST_N, DIST_P) and
    its S, on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(5)
    x = graphs.sample_gaussian_torch(
        graphs.chain_omega(DIST_P, dtype=np.float64), DIST_N, gen, dev)
    return x, (x.T @ x) / DIST_N


def dist_ranks(torch, mods, dev) -> None:
    """(b) P_DIST processes on the one card over gloo: each grid's solve
    against the single-device solve on the card."""
    import multiprocessing as mp
    import queue
    graphs, est_mod, penalty, ops = mods
    x, s = dist_problem(torch, graphs, dev)
    cfg = dict(device=str(dev), world=P_DIST, block=BLOCK, grids=DIST_GRIDS,
               init_file=str(DIST_DIR / "pg"), data=str(DIST_DIR / "xs.pt"))
    torch.save({"x": x, "s": s}, cfg["data"])
    for variant in ("cov", "obs"):
        est = est_mod.ConcordEstimator(
            penalty=penalty.PenaltySpec.l1(0.3, 0.05),
            config=dist_solve_config(est_mod, "reference", variant))
        rep = (est.fit_cov(s, n_samples=DIST_N) if variant == "cov"
               else est.fit(x)).report_
        cfg[variant] = str(DIST_DIR / f"ref_{variant}.pt")
        torch.save({"omega": rep.omega, "iters": rep.iters,
                    "ls_total": rep.ls_total}, cfg[variant])
        print(f"dist P={P_DIST} single-device {variant}: iters={rep.iters} "
              f"trials={rep.ls_total} wall={rep.wall_time_s:.3f} s")
    del x, s
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_dist_rank, args=(r, cfg, out_q))
             for r in range(P_DIST)]
    t0 = time.perf_counter()
    for pr in procs:
        pr.start()
    results = {}
    try:
        while len(results) < P_DIST:
            try:
                rank, ok, val = out_q.get(timeout=600)
            except queue.Empty:
                fail("dist ranks: no result within 600 s")
            check(ok, f"dist rank {rank} failed:\n{val}")
            results[rank] = val
    finally:
        for pr in procs:
            pr.join(timeout=60)
            if pr.is_alive():
                pr.terminate()
                pr.join(timeout=30)
    wall = time.perf_counter() - t0
    check(all(pr.exitcode == 0 for pr in procs),
          f"dist ranks exit codes {[pr.exitcode for pr in procs]}")
    print(f"dist P={P_DIST}: {P_DIST} gloo ranks on one card, "
          f"{len(DIST_GRIDS)} solves in {wall:.1f} s (process start "
          f"included)")
    for i, (variant, cx, co) in enumerate(DIST_GRIDS):
        rows = [results[r][i] for r in range(P_DIST)]
        r0 = rows[0]
        print(f"dist P={P_DIST} {variant} (c_x={cx}, c_omega={co}): iters="
              f"{r0['iters']} trials={r0['trials']} vs single-device "
              f"{r0['want']}; max |dOmega| {max(r['err'] for r in rows):.3e}"
              f" (max |Omega| {r0['scale']:.3e}); wall per rank "
              f"{max(r['wall'] for r in rows):.2f} s; density "
              f"{r0['density']:.4f}")
        for r, row in enumerate(rows):
            print(f"  rank {r}: shard {row['shard']} launches "
                  f"{row['launches']} host copies {row['host_copies']}; "
                  f"kernel 1 on its shard out max |d| {row['err1']:.1e}, "
                  f"kernel 2 {row['tile'][0]}@{row['tile'][1]} at "
                  f"{row['occupied']} blocks max |d| {row['err2']:.2e}; "
                  f"one product's wire bytes {row['bytes']} vs comm_volume "
                  f"{row['volume']}")
        for row in rows:
            check((row["iters"], row["trials"]) == tuple(row["want"]),
                  f"dist {variant} ({cx},{co}): counts differ from the "
                  f"single-device solve")
            check(row["converged"] and not row["stalled"],
                  f"dist {variant} ({cx},{co}): no convergence")
            check(row["err"] <= 1e-10 * max(1.0, row["scale"]),
                  f"dist {variant} ({cx},{co}): Omega differs beyond 1e-10")
            check(row["launches"]["fused_prox_stats"] == row["trials"],
                  f"dist {variant} ({cx},{co}): kernel 1 launches != trials")
            check(row["launches"]["blocksparse_matmul"] > 0,
                  f"dist {variant} ({cx},{co}): kernel 2 never ran")
            check(row["bytes"] == row["volume"],
                  f"dist {variant} ({cx},{co}): wire bytes != comm_volume")


def dist_kernel_times(torch, ops, ref, dev) -> None:
    """Kernels 1 and 2 at the shapes this slice gives them, timed alone on
    the card: kernel 1 on a rank's panel with its off-origin diagonal
    mask (world size 1: the whole 16384^2 matrix; P = 4: a (4096, 1024)
    Cov panel), kernel 2 on a ring round's tile (1024, 4096) @
    (4096, 1024) at ~3% occupied blocks."""
    gen = torch.Generator(device=dev).manual_seed(9)
    f64 = dict(dtype=torch.float64, device=dev)
    for (m, n), lo in (((P_MAIN, P_MAIN), 0), ((DIST_P, DIST_P // P_DIST),
                                               DIST_P // P_DIST)):
        z = 0.1 * torch.randn((m, n), generator=gen, **f64)
        dm = torch.zeros_like(z)
        dm[lo:lo + n].diagonal().fill_(1.0)
        z[lo:lo + n].diagonal().add_(1.0)
        gm, gn = -(-m // BLOCK), -(-n // BLOCK)
        ms = time_ms(torch, lambda: ops.fused_prox_stats(
            z, dm, 0.03, block=(BLOCK, BLOCK)), 20)
        plain = time_ms(torch, lambda: ref.fused_prox_stats(
            z, dm, 0.03, block=(BLOCK, BLOCK)), 3, 1)
        b, by = bound(3 * m * n * 8 + gm * gn * 5 * 8, 10.0 * m * n,
                      "float64")
        print(f"dist kernel 1 at {m}x{n}, explicit diagonal mask at row "
              f"{lo}: {ms:.3f} ms, plain {plain:.3f} ms, bound {b:.3f} ms "
              f"({by})")
        del z, dm
    m, k = DIST_P // P_DIST, DIST_P
    keep = torch.rand((m // BLOCK, k // BLOCK), generator=gen,
                      device=dev) < 0.03
    mask = keep.to(torch.int8)
    a = torch.randn((m, k), generator=gen, **f64)
    a *= keep.repeat_interleave(BLOCK, 0).repeat_interleave(BLOCK, 1)
    b = torch.randn((k, m), generator=gen, **f64)
    occ = max(1, int(keep.sum()))
    ms = time_ms(torch, lambda: ops.masked_matmul(
        a, b, mask, block_size=BLOCK, capacity=occ), 20)
    plain = time_ms(torch, lambda: ref.masked_matmul(
        a, b, mask, block_size=BLOCK, capacity=occ), 3, 1)
    lib = time_ms(torch, lambda: a @ b, 5, 1)
    rows_b = int(keep.any(dim=0).sum())
    bnd, by = bound(occ * BLOCK * BLOCK * 8 + rows_b * BLOCK * m * 8
                    + mask.numel() + m * m * 8,
                    2.0 * occ * BLOCK * BLOCK * m, "float64")
    print(f"dist kernel 2 at ({m}, {k}) @ ({k}, {m}), {occ} of "
          f"{mask.numel()} blocks: {ms:.3f} ms, plain {plain:.3f} ms, dense "
          f"torch.matmul {lib:.3f} ms, bound {bnd:.3f} ms ({by})")


def dist_path(torch, mods, dev, profile: bool) -> None:
    from repro_torch.kernels import ref
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    try:
        dist_world1(torch, mods, dev, profile)
        dist_cli(torch, mods, dev)
        dist_ranks(torch, mods, dev)
        dist_kernel_times(torch, mods[3], ref, dev)
    finally:
        shutil.rmtree(DIST_DIR, ignore_errors=True)


def path_mode_costs(torch, mods, state) -> None:
    """The step cost of ``fit_path``'s modes at p = 16384 on the main S:
    a sequential trial (cold points, kernel 2 with sparse on; dense with
    it off, one point) against a lane trial of the batched engine with
    the pilot warm start; then the mode ``fit_path(mode="auto")`` picks
    on the card with the committed ``CARD_STEP_COST``."""
    from repro_torch.core.costmodel import CARD_STEP_COST, choose_path_mode
    _, est_mod, penalty, ops = mods
    s = state["s"]
    pen = penalty.PenaltySpec.l1(0.3, 0.05)

    def est(**kw):
        return est_mod.ConcordEstimator(penalty=pen, config=batched_config(
            est_mod, **kw))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    seq, w_seq = timed(lambda: est(sparse_matmul="on").fit_path(
        s=s, lam1_grid=LAM_PATH, n_samples=N_MAIN, warm_start=False,
        score_bic=False))
    dense, w_dense = timed(lambda: est(sparse_matmul="off").fit_cov(
        s, n_samples=N_MAIN).report_)
    bat, w_bat = timed(lambda: est(batch_warm_start="pilot").fit_path(
        s=s, lam1_grid=LAM_PATH, n_samples=N_MAIN, mode="batched",
        score_bic=False))
    lane = w_bat / bat.batch_stats.lane_steps
    t_seq, t_dense = w_seq / seq.total_ls, w_dense / dense.ls_total
    print(f"pathmode: sequential cold, sparse on: {seq.total_ls} trials "
          f"{w_seq:.3f} s ({1e3 * t_seq:.2f} ms/trial); sequential dense "
          f"(lam1 0.3): {dense.ls_total} trials {w_dense:.3f} s "
          f"({1e3 * t_dense:.2f} ms/trial); batched with the pilot: "
          f"{bat.batch_stats.lane_steps} lane trials in "
          f"{len(bat.batch_stats.capacities)} flat steps {w_bat:.3f} s "
          f"({1e3 * lane:.2f} ms/lane trial)")
    print(f"pathmode: measured step cost blocksparse {lane / t_seq:.3f}, "
          f"dense {lane / t_dense:.3f}; committed CARD_STEP_COST "
          f"{CARD_STEP_COST}")
    grid = sorted(LAM_PATH, reverse=True)
    auto = est(sparse_matmul="on", batch_warm_start="pilot")
    picked = auto._resolve_path_mode(
        "auto", grid, est_mod.Problem.from_data(s=s, n_samples=N_MAIN,
                                                device=s.device))
    cpu = choose_path_mode(grid, gemm="xla", warm_start="pilot")
    print(f"pathmode: fit_path(mode='auto') on the card picks {picked!r} "
          f"(the reference's CPU-host class would pick {cpu!r}); "
          f"sequential {w_seq:.2f} s vs batched {w_bat:.2f} s")
    check(picked == "sequential", "fit_path(mode='auto') on the card did "
          "not pick sequential with sparse on")
    for r in (*seq, *bat):
        check(r.converged and not r.stalled, f"pathmode lam1={r.lam1} "
              f"failed")


# ---------------------------------------------------------------------------
# phase 7: timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def timing(torch, ops, ref, state) -> dict:
    from repro_torch.core.objective import gradient_from_w
    omega, s = state["omega"], state["s"]
    p, bs = omega.shape[0], BLOCK
    gm = -(-p // bs)
    measured = {}
    # kernel 1 at a main-path trial: z = Omega - tau * grad, alpha = tau*lam1
    tau = 0.5
    z = omega - tau * gradient_from_w(omega, omega @ s, state["lam2"])
    alpha = tau * state["lam1"]
    # the weighted body at the adaptive path's weights 1 / (|Omega| + eps)
    wz = 1.0 / (omega.abs() + 1e-3)
    for name, w in (("fused_prox_stats", None),
                    ("fused_prox_stats[weighted]", wz)):
        ms = time_ms(torch, lambda: ops.fused_prox_stats(
            z, None, alpha, weights=w, block=(bs, bs)), 20)
        plain = time_ms(torch, lambda: ref.fused_prox_stats(
            z, None, alpha, weights=w, block=(bs, bs)), 5, 1)
        # z (and w) in, out + stats out
        nbytes = (2 + (w is not None)) * p * p * 8 + gm * gm * 5 * 8
        b, by = bound(nbytes, (8.0 + (w is not None)) * p * p, "float64")
        measured[name] = {"ms": ms, "plain_ms": plain, "bound_ms": b,
                          "bound_by": by, "library_ms": None}
    del z, wz
    # kernel 2 at the main path's product: W = Omega S over Omega's tiles
    mask = (ref.block_nnz(omega, (bs, bs)) > 0).to(torch.int8)
    occ = int(mask.sum())
    cols = int(mask.any(dim=0).sum())                # block-rows of S read
    k2 = time_ms(torch, lambda: ops.masked_matmul(
        omega, s, mask, block_size=bs, capacity=occ), 10)
    k2_plain = time_ms(torch, lambda: ref.masked_matmul(
        omega, s, mask, block_size=bs, capacity=occ), 3, 1)
    lib2 = time_ms(torch, lambda: omega @ s, 3, 1)
    nbytes = occ * bs * bs * 8 + cols * bs * p * 8 + mask.numel() \
        + p * p * 8
    b2, by2 = bound(nbytes, 2.0 * occ * bs * bs * p, "float64")
    measured["blocksparse_matmul"] = {"ms": k2, "plain_ms": k2_plain,
                                      "bound_ms": b2, "bound_by": by2,
                                      "library_ms": lib2,
                                      "library_bsr_ms": bsr_library_ms(
                                          torch, ops, omega, s, mask, bs)}
    # kernel 3 at the batched path's shape: C lanes of p x p, both bodies
    gen = torch.Generator(device=omega.device).manual_seed(5)
    c = LANES
    for name, weighted in (("fused_path_step", False),
                           ("fused_path_step[weighted]", True)):
        torch.cuda.empty_cache()
        args, wts = path_step_inputs(torch, gen, omega.device, weighted)
        ms = time_ms(torch, lambda: ops.fused_path_step(*args, weights=wts),
                     10)
        plain = time_ms(torch, lambda: ref.fused_path_step(
            *args, weights=wts), 2, 1)
        # Omega, W (and the weights) in once, cand out; (C, 3) + (C, 5)
        nbytes = (3 + weighted) * c * p * p * 8 + c * 8 * 8
        b, by = bound(nbytes, (20.0 + weighted) * c * p * p, "float64")
        measured[name] = {"ms": ms, "plain_ms": plain, "bound_ms": b,
                          "bound_by": by, "library_ms": None}
        del args, wts
    return measured


def bsr_library_ms(torch, ops, omega, s, mask, bs):
    """The sparse yardstick of kernel 2: ``omega.to_sparse_bsr((bs, bs)) @
    s`` (PyTorch's block-sparse product), the conversion outside the timed
    window; timed here only, the port never calls it.  None, with
    PyTorch's reason printed, where PyTorch refuses the product."""
    try:
        sp = omega.to_sparse_bsr((bs, bs))
        got = sp @ s
    except (RuntimeError, NotImplementedError) as exc:
        print(f"library: PyTorch refuses the f64 BSR product on the card: "
              f"{str(exc).splitlines()[0]}")
        return None
    diff = float((got - ops.masked_matmul(omega, s, mask, block_size=bs,
                                          capacity=int(mask.sum())))
                 .abs().max())
    del got
    ms = time_ms(torch, lambda: sp @ s, 3, 1)
    print(f"library: f64 BSR product ({sp._nnz()} blocks of {bs}x{bs}) "
          f"{ms:.3f} ms, max |d| from the kernel {diff:.3e}")
    return ms


def kernel_rows(kman, measured, errs, launches, smi) -> list[dict]:
    """The ``kernels`` JSON rows of every kernel body timed in this run."""
    print(f"timing on {smi}:")
    rows = []
    for e in kman.KERNEL_ENTRIES:
        for body, site in enumerate(e["replaces"]):
            name = e["name"] + ("[weighted]" if body else "")
            if name not in measured:
                continue
            m = measured[name]
            lib = ("" if m["library_ms"] is None
                   else f", library {m['library_ms']:.3f} ms")
            if m.get("library_bsr_ms") is not None:
                lib += f", BSR library {m['library_bsr_ms']:.3f} ms"
            print(f"  {name}: kernel {m['ms']:.3f} ms, plain "
                  f"{m['plain_ms']:.3f} ms{lib}, bound {m['bound_ms']:.3f} "
                  f"ms ({m['bound_by']}), launches {launches.get(name, 0)}")
            rows.append({"name": name, "route": e["route"],
                         "source": e["source"], "replaces": site,
                         "launches": launches.get(name, 0),
                         "max_abs_err": errs[name], **m})
    return rows


def _profile(torch, fn):
    """(wall s, device-busy s, [(device s, count, kernel)]) of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: the host ops that launched them carry the
    # same time again
    rows = [(e.self_device_time_total / 1e6, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    check(busy > 0, "the profiler saw no device time")
    return out, wall, busy, rows


def profile_fit(torch, mods, state):
    """Device time by kernel over one warm Cov fit and one batched path at
    the main path's size, and the card's idle share of each wall time."""
    _, est_mod, penalty, _ = mods
    cfg = est_mod.SolverConfig(backend="reference", variant="cov",
                               use_pallas=True, sparse_matmul="on",
                               dtype="float64")
    est = est_mod.ConcordEstimator(penalty=penalty.PenaltySpec.l1(0.3, 0.05),
                                   config=cfg)
    _, wall, busy, rows = _profile(
        torch, lambda: est.fit_cov(state["s"], n_samples=N_MAIN))
    rep = est.report_
    print(f"profile: fit_cov iters={rep.iters} trials={rep.ls_total} "
          f"wall={wall:.3f} s (profiled), device busy {busy:.3f} s, idle "
          f"share {1.0 - busy / wall:.3f}")
    for secs, n, key in rows[:12]:
        print(f"  {100 * secs / wall:5.1f}% {1e3 * secs / rep.ls_total:7.3f}"
              f" ms/trial x{n:<5d} {key[:90]}")
    est = est_mod.ConcordEstimator(penalty=penalty.PenaltySpec.l1(0.3, 0.05),
                                   config=batched_config(est_mod))
    path, wall, busy, rows = _profile(torch, lambda: est.fit_path(
        s=state["s"], lam1_grid=LAM_PATH, n_samples=N_MAIN, mode="batched",
        score_bic=False))
    st = path.batch_stats
    steps = len(st.capacities)
    print(f"profile: batched fit_path {len(path)} lanes, {steps} flat steps,"
          f" {st.lane_steps} lane trials, wall={wall:.3f} s (profiled), "
          f"device busy {busy:.3f} s, idle share {1.0 - busy / wall:.3f}")
    for secs, n, key in rows[:12]:
        print(f"  {100 * secs / wall:5.1f}% {1e3 * secs / steps:8.3f}"
              f" ms/flat step x{n:<5d} {key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="all",
                    help="comma list of kernels,main,batched,adaptive,obs,"
                         "gram,lm,dist,pathmode,cross,timing (default: "
                         "all; device and build always run; pathmode "
                         "needs main)")
    ap.add_argument("--profile", action="store_true",
                    help="after the phases, profile one warm main-path fit "
                         "and one batched path (needs the main phase) and "
                         "one loss_fn (needs the lm phase); the gram phase "
                         "profiles one prep's streaming pass")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import estimator as est_mod
    from repro_torch.core import graphs, penalty
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import manifest as kman

    want = set(args.phases.split(",")) if args.phases != "all" else None
    run = lambda name: want is None or name in want   # noqa: E731
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    mods = (graphs, est_mod, penalty, ops)

    phase("device")
    name, count, smi = device_line(torch)
    phase("build")
    build_kernels(build)
    errs, state, lm_state, launches, measured = {}, None, None, {}, {}
    if run("kernels"):
        phase("kernels")
        check_kernels(torch, kman, ops, ref, dev)
        errs = check_kernels_main_shape(torch, kman, ops, ref, dev)
        errs["flash_attention"] = check_flash(torch, kman, ops, ref, dev)
        torch.cuda.empty_cache()
    if run("main"):
        phase("main")
        state = main_path(torch, mods, dev)
        launches.update(state["launches"])
    if run("batched") and state is not None:
        phase("batched")
        launches["fused_path_step"] = batched_path(
            torch, mods, state)["launches"]
        torch.cuda.empty_cache()
    if run("adaptive"):
        phase("adaptive")
        launches.update(adaptive_paths(torch, mods, dev))
    if run("obs"):
        phase("obs")
        obs_fit(torch, mods, dev)
        torch.cuda.empty_cache()
    if run("gram"):
        phase("gram")
        gram_path(torch, mods, dev, args.profile)
        torch.cuda.empty_cache()
    if run("lm"):
        phase("lm")
        lm_state = lm_path(torch, dev, ops)
        launches["flash_attention"] = lm_state["launches"]
        torch.cuda.empty_cache()
    if run("dist"):
        phase("dist")
        dist_path(torch, mods, dev, args.profile)
        torch.cuda.empty_cache()
    if run("pathmode") and state is not None:
        phase("pathmode")
        path_mode_costs(torch, mods, state)
        torch.cuda.empty_cache()
    if run("cross"):
        phase("cross")
        cross_check(torch, mods, dev)
        if lm_state is not None:
            cross_check_lm(torch, ops, lm_state)
        torch.cuda.empty_cache()
    if run("timing") and errs:
        phase("timing")
        if state is not None:
            measured.update(timing(torch, ops, ref, state))
        measured["flash_attention"] = timing_flash(torch, ops, ref, dev)
        torch.cuda.empty_cache()
    if args.profile and state is not None:
        phase("profile")
        profile_fit(torch, mods, state)
    if args.profile and lm_state is not None:
        phase("profile lm")
        profile_lm(torch, lm_state)
    if measured:
        rows = kernel_rows(kman, measured, errs, launches, smi)
        print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
