#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                 # every phase, one card

Phases, in order; any failure exits non-zero and prints no result line:

  1. device     card name, device count, ``nvidia-smi`` name + power limit
  2. build      nvcc builds ``src/repro_torch/kernels/csrc/*.cu`` for
                sm_90a (one process per source, all at once) and prints
                registers / shared memory / spills per kernel; the
                checked builds (``-DREPRO_KCHECK``) and their probes
                start at the same time and compile on beside the next
                phases until the analysis phase waits for them
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
  9c. telemetry observability on the main cell: ``fit_cov`` warm at obs
                off / summary / trace (Omega bit-identical, equal counts and
                kernel 1 / 2 launches; walls and overheads; the span tree
                and the ``repro_solve_*`` counters), a 3-point traced
                ``fit_path`` exported as a Chrome trace and read back by
                ``python -m repro_torch.obs.cli print`` / ``export``; the
                dense distributed solve at obs trace, reconciled row by row
                against ``comm_volume``: world size 1 through NCCL (Cov on
                S, Obs on X, n = 8192), P_DIST gloo ranks at p = 2048 on
                Cov (4,2,2) and Obs (4,1,2), and ``torchrun
                --nproc-per-node 1 -m repro_torch.obs.cli reconcile``
  9d. serve     ``launch.serve --workload concord --requests 16 --batch 4
                --p 4096 --n 1200 --obs summary`` (a multi-subject queue,
                one resting-state run of 1200 frames per subject on a
                4096-region parcellation): 16 reports in request order, 4
                groups of (4, 1200, 4096), max_gap < 5e-3, the three latency
                histograms counting 16; req/s, latency p50 / p99, peak
  9e. pathmode  the step cost of ``fit_path``'s two modes at p = 16384 with
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
 12. calibrate  kernel 2 against the dense product at p = 16384, block 128,
                m = 16384 (Cov's Omega S) and 1200 (Obs's Omega X^T) over
                block densities 1/128 to 1 (seeded masks built by
                ``matops.block_mask``), CUDA events; the rows, the fitted
                ``BlockSparseModel`` and its residuals, both crossovers
                (data sheet, fitted) beside ``CARD_BLOCK_MODEL``'s; kernel
                2 against its plain version at two of the rows
 12b. brain     the paper's Section 5 pipeline
                (``examples/torch_brain_clustering.py``) on a 128 x 128
                cortex (p = 16384) of 64 regions, n = 1200 frames drawn on
                the card: a warm ``fit_path`` per lam2 in {0.05, 0.1} over
                lam1 in {0.12, 0.16, 0.2, 0.25} through kernels 1 and 2
                (``sparse_matmul="auto"``: the card's calibrated
                threshold), the watershed at eps 0 / 1 / 2, label
                propagation, the thresholded-covariance baseline, the
                example's assertion (hard); the chosen point cold through
                the kernels and at the reference example's config (dense,
                no kernel): support agreement, counts, max |dOmega|
 13. lmserve    LM serving through ``launch.serve.serve_batch`` (after the
                profiles; it reuses and then frees the lm phase's model):
                (a) h2o-danube-1.8b at full width and depth, 8 prompts of
                4096 tokens (its window ring, full) and 128 greedy
                tokens; (b) a single-shot prefill of 2 x 6083 tokens into
                that 4096-slot ring and a decode step, against the
                cache-free forward; (c) OLMoE-1B-7B at full width and
                depth, 4 prompts of 16384 tokens through its chunked
                prefill (2 x 8192) and 64 greedy tokens, then a 512-token
                cross-check at the drop-free capacity factor.  Prefill
                wall, ms per decode step (mean, p99), decode tokens/s,
                peak; decode steps under ``set_sync_debug_mode("error")``;
                no kernel launches (the reference's cached path reaches
                none)
 14. zoo        the LM zoo's last three families at full width and depth,
                random seeded weights: (a) Zamba2-7B (81 layers: 27
                groups of the shared attention block + 3 Mamba2 layers)
                ``loss_fn`` on 1 batch of 2 x 4096, ``serve_batch`` on 4
                x 4096 prompts + 64 tokens, a cross-check at a 6-layer cut
                and at the full 81 layers (f32 within 2e-3; bf16 within
                5e-2 or 2x the bf16 forward's own error);
                (b) Mamba2-130M, 8 x 4096 + 128; (c) Whisper-small (12 +
                12 layers, 1500 seeded frames), 8 x 64 + 192 within its
                448-token context; each also ``loss_fn`` and one decode
                step against the cache-free forward in bf16 and f32.
                Prefill wall, ms per decode step (mean, p99), decode
                tokens/s, peak, the cache by part, kernel-4 launches (0:
                the reference routes none of them through flash)
 15. trainmp    multi-rank training (``train(mesh=)``): (a) danube-1.8b at
                full width and depth on the (1, 1) mesh of a one-rank NCCL
                group, 1 step of 4 x 4096, against one process (the train
                phase's run), and ``torchrun --nproc-per-node 1 -m
                repro_torch.launch.train --mesh host`` on a smoke config
                against ``--mesh none``; (b) P_DIST gloo ranks sharing the
                card, danube at 2 layers on mesh (2, 2), split over a
                model team of 2 (the "split" route), 1 step of 4 x 4096,
                against one process; (c) OLMoE-1B-7B at 1 layer on mesh
                (4, 1) (the per-shard MoE dispatch), 1 step of 8 x 2048,
                its step-1 loss against one process dispatching the same
                token blocks in turn; (d) the int8 ring and the bf16 psum
                of 16M float32 per rank, their error and wire bytes; (e)
                OLMoE-1B-7B at 1 layer on mesh (1, 4), 16 of its 64
                experts on each rank, 1 step of 8 x 2048 against one
                process; (f) Mamba2-130M at full width cut to 12 layers
                on mesh (2, 2), its SSM split over a model team of 2 (12
                of its 24 heads per rank), 2 steps of 8 x 2048; (g)
                Zamba2-7B at full width cut to 6 layers (2 groups) on
                mesh (1, 4), 28 of its 112 SSM heads, 8 of the shared
                block's 32 attention heads and a quarter of d_ff per
                rank; (h) Whisper-small at full width cut to 6 + 6
                layers on mesh (2, 2), its MLP, heads and vocabulary
                split over a model team of 2, 1 step each (the script's
                time); each against one
                process.  Step walls, state bytes per
                rank, each rank's ssm_out / attn_wq blocks, gloo host
                copies and wire bytes per step, peaks, MoE drops; no
                kernel launches
 15b. servemp   prefill and decode on a mesh (``lm.make_prefill`` /
                ``make_decode_step`` with ``mesh=``, every rank its
                blocks of the weights and of the cache under the
                reference's ``cache_shardings``): P_DIST gloo ranks
                sharing the card in one spawn, bf16, seeded weights at
                full width: (a) h2o-danube-1.8b at 2 layers on (2, 2), 4
                x 4096 + 32 greedy tokens (kv heads over "model", rows
                over "data"); (b) Qwen2.5-3B at 2 layers on (1, 4), 2 x
                8192 + 32 (its 2 kv heads whole: the ring split by slots,
                each step's softmax combined across the ranks); (c)
                OLMoE-1B-7B at 1 layer on (1, 4), 16 of 64 experts per
                rank, 2 x 16384 through its chunked prefill + 32; (d)
                Zamba2-7B at 6 layers on (1, 4), 2 x 4096 + 16 (and in
                f32, + 4); (e) Whisper-small on (2, 2), 1 x (1500
                frames, 64 tokens) + 8 (its encoder output split over
                "data").  Each against
                one process running the same calls on the same weights:
                prefill logits and the gathered cache within 5e-2 of
                their max (``pos`` exact), decode teacher-forced with one
                process's tokens, at most 2 of a sequence's greedy tokens
                different beyond a near-tie (one process's top-2 margin
                within 2^-7 of max |logit|: two bf16 ulps; every flip
                printed with its margin), no kernel launched; ms per
                decode step, wire
                bytes and gloo host copies per step, peak and cache
                bytes per rank

 16. analysis   ``repro_torch.analysis`` on the card: (a) the differential
                fuzzer over every ``configs`` and ``card_configs`` entry of
                the kernel manifest in each declared dtype (f64 / f32; f32 /
                bf16 for flash) at 4 seeds, under its guard (NaN guard bands
                around the inputs, a poisoned allocator, each case twice
                bit for bit), every case passing and every kernel
                launched; (b') the kernels' checked build (``-DREPRO_KCHECK``,
                ``kernelpass.kcheck``): its five planted-fault probes each
                reported under its rule (CA403 a store past the end and a
                shared access past the allocation, CA402 a tile never
                stored, CA401 a tile stored twice and, by jitter, a
                missing barrier), then every seed-0 case through the
                checked libraries with 0 findings: every access inside
                its buffers, every output element stored exactly once,
                the outputs bit-identical across 3 jitter seeds; (b) with
                ``--sanitize`` only, ``compute-sanitizer``
                memcheck, racecheck and initcheck over the seed-0 cases,
                each with a clean summary (a tool that refuses the card
                fails); (c) the CLI's default run on the card (AST engine,
                dispatch engine, CA405), 0 findings against
                ``analysis_baseline_torch.json``; (d) the dispatch engine
                at f64 on the card (no CA201, no finding) and the host-sync
                census held against PERF.md section 2
 17. dryrun     ``repro_torch.launch.dryrun``: (a) the dry run (fake CUDA
                tensors, FlopCounterMode, the live-storage tracker) of the
                train phase's danube-1.8b step, 4 x 4096, one process,
                against one real warm step on the card: flops equal to
                FlopCounterMode's, the peak within 10% of
                ``max_memory_allocated``, the roofline bound at H100
                data-sheet constants beside the warm wall, the share of
                the roofline and MFU; (a') ``loss_fn`` at 2 x 8192 through
                kernel 4 on the card and on fake tensors, its flops by the
                custom op's rule equal to the visible-pair closed form,
                24 launches; (b) three CLI cells as subprocesses (a fake
                process group of 256 / 512 ranks never shares this
                process's real groups), started before (a): danube
                train_4k on both meshes, OLMoE-1B-7B decode_32k, danube
                prefill_32k with ``attention_impl="flash"``; each exits 0
                with the reference's record keys

The kernels phase also holds the flash kernel against its plain version
at every manifest config (f32, bf16) and at the LM path's shape (B 2,
Hq 32, Hkv 8, L 8192, D 80, causal, window 4096, bf16).

``--profile`` adds a torch.profiler pass over one warm main-path fit, one
batched path, one prep's streaming pass at the gram phase's size, one
``loss_fn`` at the lm shape, one serve group against its requests one
by one and 8 decode steps of each lmserve and zoo model (device time by
kernel, the card's idle share); ``--sanitize`` adds the analysis phase's
compute-sanitizer runs; ``--phases`` runs a subset while iterating (e.g.
``--phases kernels,lm`` or ``--phases gram``).

The second-to-last line is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import argparse
import atexit
import json
import os
import shutil
import subprocess
import sys
import time
from fractions import Fraction
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

#: the telemetry phase: the main cell's fit at every obs level, a traced
#: path exported to TELE_DIR; the dense distributed reconciliation at
#: world size 1 (NCCL) on the main S and X, and on P_DIST gloo ranks at
#: TELE_P x TELE_N on TELE_GRIDS
TELE_P, TELE_N = 2048, 4096
TELE_GRIDS = (("cov", 2, 2), ("obs", 1, 2))
TELE_DIR = ROOT / "build" / "telemetry_phase"

#: the serve phase: a multi-subject queue, one resting-state run per
#: subject at 1200 frames (HCP's) on a 4096-region parcellation
SERVE_REQUESTS, SERVE_BATCH, SERVE_P, SERVE_N = 16, 4, 4096, 1200
SERVE_ARGV = ["--workload", "concord", "--requests", str(SERVE_REQUESTS),
              "--batch", str(SERVE_BATCH), "--p", str(SERVE_P), "--n",
              str(SERVE_N), "--obs", "summary"]

#: the calibrate phase: kernel 2 against the dense product at P_MAIN x m for
#: m in CAL_MS (Cov's Omega S; Obs's Omega X^T at the brain cell's n) over
#: CAL_DENSITIES block densities; kernel 2 held against its plain version
#: at the (m, density) pairs of CAL_PLAIN (the plain gather at m = P_MAIN
#: and density 0.3 would take 82 GB)
CAL_MS = (P_MAIN, N_OBS)
CAL_DENSITIES = (1 / 128, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 1.0)
CAL_PLAIN = {(P_MAIN, 0.02), (N_OBS, 0.3)}
#: the brain phase: examples/torch_brain_clustering.py's pipeline on a
#: BRAIN_SIDE x BRAIN_SIDE cortex (p = 16384) of BRAIN_REGION^2-vertex
#: regions (64), BRAIN_N frames (HCP's per resting-state run)
BRAIN_SIDE, BRAIN_REGION, BRAIN_N, BRAIN_SEED = 128, 16, 1200, 0

#: the LM slice: h2o-danube-1.8b at full width, loss on LM_BATCHES batches
#: of (LM_B, LM_L) tokens; the cross-check cuts it to CROSS_LAYERS layers
LM_ARCH, LM_B, LM_L, LM_BATCHES, CROSS_LAYERS = "h2o_danube_1p8b", 2, 8192, 3, 2
#: the lmserve phase: (a) danube serving, SERVE_LM_B prompts of
#: SERVE_LM_PROMPT tokens (they fill its 4096-slot window ring, so the
#: decode wraps it), then SERVE_LM_GEN greedy tokens; (b) a single-shot
#: prefill of RING_B prompts of RING_PROMPT tokens (longer than the ring)
#: and one decode step, against the cache-free forward (6083 and 6084
#: keys: the "chunked" attention runs over the largest divisor <= 1024 of
#: the key count, 869 and 1014 here, where 6143 = 1.5 x 4096 - 1 is prime
#: and would run it over 6143 one-key chunks); (c) OLMoE serving through
#: its native chunked prefill (OLMOE_PROMPT / prefill_chunk segments),
#: and a cross-check on one OLMOE_CROSS-token prompt at the drop-free
#: capacity factor n_experts / top_k
SERVE_LM_B, SERVE_LM_PROMPT, SERVE_LM_GEN = 8, 4096, 128
RING_B, RING_PROMPT = 2, 6083
OLMOE_ARCH, OLMOE_B, OLMOE_PROMPT, OLMOE_GEN = "olmoe_1b_7b", 4, 16384, 64
OLMOE_CROSS = 512
#: bf16 serving against the cache-free forward, both through the "chunked"
#: attention: max |logit difference| / max |logit|.  The decode step's
#: probabilities are rounded to bf16 for P V where the cache-free route
#: keeps them in f32, and the two prefills run their GEMMs at other
#: shapes: a few bf16 ulps (2^-8 relative) per layer, the lm cross-check's
#: 5e-2 on hidden states
SERVE_LOGIT_TOL = 5e-2
#: the zoo phase: the LM zoo's last three families at full width and
#: depth, random seeded weights.  (a) Zamba2-7B: ``loss_fn`` on
#: ZAMBA_LOSS_BATCHES batches of (ZAMBA_LOSS_B, ZAMBA_LOSS_L), serving
#: ZAMBA_B prompts of ZAMBA_PROMPT tokens + ZAMBA_GEN greedy tokens, and
#: the cross-check at a ZAMBA_CUT-layer cut (2 groups at shared_every 3)
#: and at its full depth (ZOO_BF16_RATIO);
#: (b) Mamba2-130M: MAMBA_B x MAMBA_PROMPT + MAMBA_GEN; (c) Whisper-small
#: (12 + 12 layers, enc_len 1500): WHISPER_B seeded frame sets, a
#: WHISPER_PROMPT-token prompt + WHISPER_GEN tokens, its learned positions
#: sized at its WHISPER_CTX-token text context.  Each part's cross-check
#: prefills ZOO_CROSS_B prompts of ZOO_CROSS_PROMPT tokens (not a multiple
#: of the SSD's 256-token chunk: the zero padding; Whisper's WHISPER_CTX -
#: 1) and decodes one step, against the cache-free forward, in bf16
#: (SERVE_LOGIT_TOL) and in f32 (ZOO_F32_TOL, the CPU tests'
#: decode-vs-forward tolerance)
ZAMBA_ARCH, ZAMBA_LOSS_B, ZAMBA_LOSS_L, ZAMBA_LOSS_BATCHES = (
    "zamba2_7b", 2, 4096, 1)
ZAMBA_B, ZAMBA_PROMPT, ZAMBA_GEN, ZAMBA_CUT = 4, 4096, 64, 6
MAMBA_ARCH, MAMBA_B, MAMBA_PROMPT, MAMBA_GEN = "mamba2_130m", 8, 4096, 128
WHISPER_ARCH, WHISPER_B, WHISPER_PROMPT, WHISPER_GEN, WHISPER_CTX = (
    "whisper_small", 8, 64, 192, 448)
ZOO_CROSS_B, ZOO_CROSS_PROMPT, ZOO_F32_TOL = 2, 4095, 2e-3
#: Zamba2-7B's cross-check at its full 81 layers: f32 within ZOO_F32_TOL;
#: bf16 within SERVE_LOGIT_TOL, or, where bf16's drift over the depth
#: exceeds it, the bf16 decode step's distance from the f32 forward within
#: ZOO_BF16_RATIO times the bf16 forward's own (the CPU tests'
#: HYBRID_BF16_RATIO for Zamba2 against the reference)
ZOO_BF16_RATIO = 2.0
#: the train phase: (a) TRAIN_ARCH at full width and depth, its own remat
#: and n_micro, TRAIN_STEPS steps of ``train()`` at TRAIN_B x TRAIN_L (the
#: reference's train_4k length; its global batch of 256 cut to fit one
#: card); (b) its weights cut to GRAD_LAYERS layers in f32 at
#: GRAD_B x GRAD_L, ``loss_fn``'s gradients through the chunked route
#: against the "ref" route within GRAD_TOL of each leaf's max |g|; (c)
#: examples/torch_lm_train.py's 300 steps, checkpoints under TRAIN_DIR,
#: the step-300 checkpoint restored bit for bit, RESUME_STEPS steps
#: resumed from step RESUME_FROM within RESUME_TOL of the first run's
#: losses; (d) FAMILY_TRAIN: (arch, batch, length) at full width and
#: depth, their own n_micro, FAMILY_STEPS steps each
TRAIN_ARCH, TRAIN_B, TRAIN_L, TRAIN_STEPS = "h2o_danube_1p8b", 4, 4096, 4
GRAD_LAYERS, GRAD_B, GRAD_L, GRAD_TOL = 2, 1, 2048, 1e-3
TRAIN_DIR = ROOT / "build" / "train_phase"
RESUME_FROM, RESUME_STEPS, RESUME_TOL = 200, 20, 1e-3
FAMILY_TRAIN = (("mamba2_130m", 8, 2048), ("whisper_small", 8, 448))
FAMILY_STEPS = 2
#: the trainmp phase (multi-rank training): (a) TRAIN_ARCH at full width
#: and depth on a one-rank NCCL group, mesh (1, 1), TRAINMP_STEPS steps of
#: TRAIN_B x TRAIN_L, held within MP_W1_TOL (relative) of a one-process
#: ``train()`` (the train phase's, whose first steps run the same
#: warm-up learning rates); (b) P_DIST gloo ranks sharing the card on
#: MP_DENSE_MESH, MP_DENSE_STEPS step(s) at MP_DENSE_LAYERS layers,
#: against one process
#: within MP_STEP1_TOL at step 1 and MP_LATER_TOL later (bf16 compute,
#: other summation orders); (c) OLMOE_ARCH cut to MP_MOE_LAYERS layer(s)
#: on MP_MOE_MESH (the per-shard MoE dispatch), MP_MOE_C_STEPS step(s) of
#: MP_MOE_B x MP_MOE_L in MP_MOE_MICRO micro-batches, its step-1 loss
#: against one process dispatching the same token blocks in turn within
#: MP_MOE_TOL; (d) the int8 ring and the bf16 psum on P_DIST ranks, CUDA
#: tensors of MP_COLL_N float32 each, within the reference test's bounds;
#: (e) OLMOE_ARCH at MP_MOE_LAYERS layer(s) on MP_EP_MESH, its experts
#: split over the model team (each rank E / P_DIST of them), against one
#: process within MP_STEP1_TOL at step 1 and MP_LATER_TOL later; (f)
#: MP_SSM_ARCH at full width cut to MP_SSM_LAYERS layers on MP_SSM_MESH,
#: MP_SSM_STEPS steps of MP_SSM_B x MP_SSM_L, the same; (g) MP_HYB_ARCH at
#: full width cut to MP_HYB_LAYERS layers on MP_HYB_MESH, and (h)
#: MP_AUD_ARCH at full width cut to MP_AUD_LAYERS encoder and decoder
#: layers on MP_AUD_MESH, the same (the depths cut to keep the script
#: inside its time limit; every layer runs the same code).  Every family
#: takes the split
#: route: each layer's blocks gathered as it runs, its compute split over
#: "model" (the SSM by heads)
MP_DIR = ROOT / "build" / "trainmp_phase"
TRAINMP_STEPS, MP_W1_TOL = 1, 1e-6
MP_DENSE_MESH, MP_DENSE_LAYERS, MP_DENSE_STEPS = (2, 2), 2, 1
MP_STEP1_TOL, MP_LATER_TOL = 1e-4, 2e-3
MP_MOE_MESH, MP_MOE_LAYERS, MP_MOE_STEPS = (4, 1), 1, 1
MP_MOE_C_STEPS = 1
MP_MOE_B, MP_MOE_L, MP_MOE_MICRO, MP_MOE_TOL = 8, 2048, 2, 2e-3
MP_EP_MESH = (1, 4)
MP_SSM_ARCH, MP_SSM_MESH, MP_SSM_STEPS = "mamba2_130m", (2, 2), 2
MP_SSM_LAYERS = 12
MP_SSM_B, MP_SSM_L = 8, 2048
MP_HYB_ARCH, MP_HYB_LAYERS, MP_HYB_MESH = "zamba2_7b", 6, (1, 4)
MP_HYB_STEPS, MP_HYB_B, MP_HYB_L = 1, 4, 2048
MP_AUD_ARCH, MP_AUD_MESH, MP_AUD_STEPS = "whisper_small", (2, 2), 1
MP_AUD_LAYERS = 6
MP_AUD_B, MP_AUD_L = 8, 448
MP_COLL_N, MP_RING_BOUND, MP_PSUM_BOUND = 1 << 24, 0.15, 2e-2
#: the servemp phase (prefill and decode on a mesh, ``lm.make_prefill`` /
#: ``make_decode_step`` with ``mesh=``): P_DIST gloo ranks sharing the
#: card, bf16, seeded weights at full width; each case (tag, arch,
#: layers (0: full depth), mesh, batch, prompt, greedy tokens, max_len):
#: (a) danube, kv heads over "model", rows over "data"; (b) Qwen2.5-3B,
#: its 2 kv heads whole, the ring split by slots over "model" (max_len
#: divisible by 4); (c) OLMoE-1B-7B, 16 of 64 experts per rank, its
#: chunked prefill (2 segments of 8192); (d) Zamba2-7B cut to 6 layers;
#: (e) Whisper-small at one sequence, its encoder output held split over
#: "data" and its ring's slots over "data".  Each held against one
#: process running the same calls on the same weights: prefill logits
#: and the gathered cache within SMP_TOL of their max, decode teacher-
#: forced with one process's tokens, at most SMP_FLIPS of a sequence's
#: greedy tokens different where one process's top-2 margin exceeds
#: SMP_TIE of max |logit|.  The logits are bf16 products widened, so a
#: vocabulary of 32000+ random lanes holds exact and one-ulp ties (on an
#: H100, 4 of danube's 32 tokens flipped, each at a margin of at most
#: 3.7e-3, one bf16 ulp, and one process's own logits hold exact ties);
#: SMP_TIE is two ulps, 2^-7.  The cases of SMP_F32 also run in float32,
#: mesh against one process within ZOO_F32_TOL: bf16 Zamba2 drifts too
#: far from itself for SMP_TOL (the zoo's 6-layer cut: 3.4e-2 of max
#: |logit| between one process's cached decode and its cache-free
#: forward; on an H100 its mesh-against-one gap is 6.05e-2 in bf16 and
#: 5.0e-5 in f32), so there the bf16 run is held at SMP_BF16_SPREAD
#: times one process's own bf16 error against its f32 run, each leaf and
#: the logits
SMP_DIR = ROOT / "build" / "servemp_phase"
SMP_CASES = (
    ("a", "h2o_danube_1p8b", 2, (2, 2), 4, 4096, 32, 4128),
    ("b", "qwen2p5_3b", 2, (1, 4), 2, 8192, 32, 8224),
    ("c", "olmoe_1b_7b", 1, (1, 4), 2, 16384, 32, 16416),
    ("d", "zamba2_7b", 6, (1, 4), 2, 4096, 16, 4112),
    ("e", "whisper_small", 0, (2, 2), 1, 64, 8, 448),
)
SMP_TOL, SMP_FLIPS, SMP_TIE = 5e-2, 2, 2.0 ** -7
SMP_F32, SMP_F32_GEN, SMP_BF16_SPREAD = ("d",), 4, 2.0
#: the flash kernel's shape on that path: (B, Hq, Hkv, L, D, window)
FLASH_MAIN = (LM_B, 32, 8, LM_L, 80, 4096)
#: the main shape's tolerance beside rtol, in units of each output row's
#: rms: rounding P to bf16 moves an output by ~1.7e-3 of its row's rms
#: (sd), whether the row sees 2 keys or 4096
FLASH_MAIN_ROW_TOL = 3e-2
#: phase analysis: seeds of the card fuzz; the sync census's problem
FUZZ_SEEDS = 4
CENSUS_P, CENSUS_BLOCK = 1024, 64
#: phase dryrun: (a) the dry run of the train phase's danube step (one
#: process, TRAIN_B x TRAIN_L) against one real step, its peak within
#: DRY_PEAK_TOL of the card's; (a') the cache-free forward through kernel 4
#: at the lm phase's shape; (b) the CLI's cells, records under DRY_DIR,
#: each subprocess stopped after DRY_CLI_TIMEOUT seconds
DRY_PEAK_TOL, DRY_CLI_TIMEOUT = 0.10, 600
DRY_DIR = ROOT / "build" / "dryrun_phase"
DRY_CELLS = (
    ("train", ["--arch", "h2o-danube-1.8b", "--shape", "train_4k",
               "--both-meshes"], 2),
    ("decode", ["--arch", "olmoe-1b-7b", "--shape", "decode_32k"], 1),
    ("flash", ["--arch", "h2o-danube-1.8b", "--shape", "prefill_32k",
               "--override", '{"attention_impl": "flash"}'], 1),
)


#: the script's start, for each phase's start time
_START = time.perf_counter()


def phase(name: str):
    print(f"== {name} (at {time.perf_counter() - _START:.1f} s)", flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


TRIAL_KEY = "fused_prox_stats[trial]"


def check_prox_launches(launches: dict, trials: int, what: str, *,
                        trial: bool = True) -> None:
    """Kernel 1 ran once per line-search trial: its trial entry (the
    single-device loop's) or, with ``trial=False``, its stats entry (the
    distributed solver's), and the other entry never."""
    key, other = ((TRIAL_KEY, "fused_prox_stats") if trial
                  else ("fused_prox_stats", TRIAL_KEY))
    check(launches[key] == trials and launches[other] == 0,
          f"{what}: {key} launches {launches[key]} != {trials} trials, or "
          f"{other} ran {launches[other]} times")


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
    """The four kernels' production libraries, built here, and their
    checked builds and the probes, started at the same time and left
    compiling beside the next phases until the analysis phase waits for
    them (:func:`wait_checked`).  Returns the checked builds' jobs; they
    are killed at exit if no phase waited."""
    t0 = time.perf_counter()
    checked = build.Jobs([(n, True)
                          for n in (*build.EXTRA_FLAGS, *build.PROBES)])
    atexit.register(checked.stop)
    libs = build.build()
    print(f"built {sorted(libs)} in "
          f"{time.perf_counter() - t0:.1f} s; their checked builds and "
          f"{sorted(build.PROBES)} compile on beside the next phases")
    print_ptxas(build, list(build.EXTRA_FLAGS))
    return checked


def print_ptxas(build, keys) -> None:
    for key in keys:
        for line in build.PTXAS_REPORT.get(key, "").splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "smem")):
                print(f"  ptxas[{key}] {line.strip()}")


def wait_checked(build, checked) -> None:
    """Wait for the checked builds started in the build phase; print
    each one's compile seconds and ptxas report (a checked build may
    spill: its checks add registers)."""
    t0 = time.perf_counter()
    libs = checked.wait()
    keys = [f"{n} checked" for n, _ in sorted(libs)]
    print(f"checked builds {sorted(n for n, _ in libs)} ready after "
          f"{time.perf_counter() - t0:.1f} s of waiting; compile s "
          + ", ".join(f"{k}: {build.BUILD_SECONDS[k]:.1f}" for k in keys
                      if k in build.BUILD_SECONDS))
    print_ptxas(build, keys)


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


def compare_trial(torch, ent, ops, ref, omega, grad, tau, alpha, w,
                  block) -> float:
    """The fused prox's trial entry against its plain twin on the same
    CUDA inputs: out and the tile nonzeros bit-exact, the step norms and
    ||out||^2 within the entry's rtol; returns the max abs error of out
    (0 when bit-exact)."""
    from repro_torch.kernels.manifest import TRIAL_OUTPUTS
    got = ops.fused_prox_trial(omega, grad, tau, alpha, weights=w,
                               block=block)
    torch.cuda.synchronize()
    want = ref.fused_prox_trial(omega, grad, tau, alpha, weights=w,
                                block=block)
    tol = ent["rtol"][_dt(omega.dtype)]
    for nm, g, e in zip(TRIAL_OUTPUTS, got, want):
        if nm in ent["exact"]:
            check(torch.equal(g, e), f"fused prox trial {nm} is not "
                  f"bit-exact")
        else:
            check(torch.allclose(g, e, rtol=tol, atol=tol),
                  f"fused prox trial {nm}: {float(g)} vs {float(e)}")
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
            gt = torch.as_tensor(rng.standard_normal(z.shape), dtype=dtype,
                                 device=dev)
            compare_trial(torch, soft, ops, ref, zt, gt, kman.TRIAL_TAU,
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
    print("manifest configs: fused prox (and its trial entry), "
          "block-sparse and path step agree (f32, f64, weighted inf at "
          "alpha=0, explicit and implicit diagonal)")


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
    # the trial entry at z as Omega, a gradient of the same scale, tau 0.5,
    # unweighted and at the same weights
    grad = 0.1 * torch.randn((p, p), generator=gen, dtype=torch.float64,
                             device=dev)
    for name, w in ((TRIAL_KEY, None), (TRIAL_KEY + "[weighted]", wz)):
        errs[name] = compare_trial(
            torch, kman.entry("fused_prox_stats"), ops, ref, z, grad, 0.5,
            0.15, w, (bs, bs))
    del z, wz, grad
    step = kman.entry("fused_path_step")
    for weighted in (False, True):
        torch.cuda.empty_cache()
        args, wts = path_step_inputs(torch, gen, dev, weighted)
        name = "fused_path_step" + ("[weighted]" if weighted else "")
        errs[name] = compare_step(torch, step, ops, ref, args, wts, 256)
        del args, wts
    print(f"main shapes: fused prox {p}x{p} with weights and its trial "
          f"entry, out bit-exact; path step {LANES}x{p}x{p}, both bodies, "
          f"cand bit-exact")
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
# the lmserve phase: KV-cache prefill and greedy decode
# ---------------------------------------------------------------------------

def lm_prompts(torch, cfg, b: int, length: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab, (b, length)),
                           dtype=torch.int32, device=dev)


def weight_bytes(model) -> int:
    """Bytes of the weights in the compute dtype (bf16)."""
    return 2 * sum(p.numel() for p in model.parameters())


def cache_leaves(tree: dict, prefix=()) -> list:
    """[(path, tensor)] of every leaf of a cache tree."""
    out = []
    for name, t in tree.items():
        if isinstance(t, dict):
            out += cache_leaves(t, prefix + (name,))
        else:
            out.append((prefix + (name,), t))
    return out


def serve_lm(torch, ops, cfg, model, b: int, prompt_len: int, gen: int,
             tag: str, frames=None) -> dict:
    """``launch.serve.serve_batch`` on ``b`` seeded prompts (and Whisper's
    ``frames``): prefill wall, ms per decode step (mean, p99), decode
    tokens/s, peak memory and the cache by part (KV rings, SSM state,
    ``enc_out``), with the decode step's bytes bound; the tokens in
    range, the prefill's and one more decode step's logits finite, every
    ring holding its positions by slot, 4 more steps with every host
    sync raising, no kernel launched (kernel 4's count printed)."""
    from repro_torch.launch import serve
    from repro_torch.models import layers, lm, transformer
    dev = next(model.parameters()).device
    prompts = lm_prompts(torch, cfg, b, prompt_len, seed=1, dev=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    stats = {}
    t0 = time.perf_counter()
    with layers.count_moe_drops() as tally:
        toks = serve.serve_batch(cfg, model, prompts, gen, prompt_len + gen,
                                 frames=frames, stats=stats)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launched = dict(ops.LAUNCHES)
    cache = stats.pop("cache")
    steps = 1e3 * np.asarray(stats["step_s"])
    parts, rings = {}, []
    for path, t in cache_leaves(cache):
        if path[-1] == "pos":
            rings.append(t)
            continue
        key = ("SSM state" if path[-1] in ("conv", "h") else
               "enc_out" if path[-1] == "enc_out" else "KV rings")
        parts[key] = parts.get(key, 0) + t.numel() * t.element_size()
    c_bytes = sum(parts.values())
    w_bytes = weight_bytes(model)
    bound_ms = 1e3 * (w_bytes + c_bytes) / PEAK_BYTES_PER_S
    split = ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in parts.items())
    slots = (f", rings of {rings[0].shape[-1]} slots x "
             f"{sum(r.shape[0] for r in rings)}" if rings else "")
    print(f"{tag}: {cfg.name} B {b} x prompt {prompt_len} (prefill_chunk "
          f"{cfg.prefill_chunk}), {gen} greedy tokens, cache ({split}"
          f"{slots}): prefill {1e3 * stats['prefill_s']:.1f} ms "
          f"({b * prompt_len / stats['prefill_s']:.0f} prompt tokens/s); "
          f"decode step mean {steps.mean():.3f} ms p50 "
          f"{np.quantile(steps, 0.5):.3f} p99 {np.quantile(steps, 0.99):.3f}"
          f" max {steps.max():.3f} over {len(steps)} steps = "
          f"{b * len(steps) / (steps.sum() / 1e3):.1f} decode tokens/s; "
          f"whole call {wall:.2f} s; peak {peak / 2**30:.2f} GiB; "
          f"decode bound {bound_ms:.3f} ms (bytes: {w_bytes / 1e9:.2f} GB "
          f"bf16 weights + the cache, read once); capacity dropped "
          f"{tally.dropped} of {tally.assigned} MoE (token, expert) "
          f"assignments, all at prefill (a decode step's B tokens fit the "
          f"128-slot floor); kernel-4 launches {launched['flash_attention']}")
    print(f"{tag}: sample {toks[0, :12].tolist()}")
    check(tuple(toks.shape) == (b, gen), f"{tag}: tokens shape")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"{tag}: a token outside [0, vocab)")
    check(bool(torch.isfinite(stats["logits"][:, :cfg.vocab]).all()),
          f"{tag}: non-finite prefill logits")
    # one more step from the final cache, outside the timing: its logits
    pc = lm.cast_params(cfg, model)
    pos = torch.tensor([prompt_len + gen - 1], device=dev)
    h, cache, _ = transformer.forward(cfg, pc, toks[:, -1:], pos,
                                      caches=cache)
    logits = transformer.lm_head(cfg, pc, h)[:, 0, :cfg.vocab]
    check(bool(torch.isfinite(logits).all()),
          f"{tag}: non-finite decode logits")
    check(all(bool(torch.isfinite(t.float()).all())
              for _, t in cache_leaves(cache)), f"{tag}: non-finite cache")
    for held in rings:
        width = held.shape[-1]
        check(int(held.max()) == prompt_len + gen - 1
              and bool(((held % width) == torch.arange(width, device=dev))
                       [held >= 0].all()),
              f"{tag}: a ring does not hold its positions by slot")
    # the decode loop waits for nothing: 4 more steps with every implicit
    # host sync raising (past max_len a full-attention ring wraps; the
    # work per step is the same)
    decode = lm.make_decode_step(cfg)
    nxt, at = toks[:, -1], torch.arange(prompt_len + gen,
                                        prompt_len + gen + 4, device=dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(4):
            cache, nxt = decode(pc, cache, nxt, at[i])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(peak < 80e9, f"{tag}: peak {peak / 1e9:.1f} GB >= 80 GB")
    check(not any(launched.values()),
          f"{tag}: a kernel launched on the serve path: {launched}")
    return {"prefill_s": stats["prefill_s"], "steps_ms": steps,
            "peak": peak, "dropped": tally.dropped, "cache": cache,
            "pc": pc, "bound_ms": bound_ms, "b": b,
            "pos0": prompt_len + gen + 4}


def serve_vs_forward(torch, ops, cfg, pc, prompts, last, tag: str):
    """Single-shot prefill of ``prompts`` (b, n), then one decode step at
    position n feeding ``last`` (b,) (None: the prefill's greedy token),
    against the cache-free forward + ``lm_head`` over the n + 1 tokens at
    their last position: max |d logits| / max |logit| within
    SERVE_LOGIT_TOL, greedy tokens compared, no MoE drop, no kernel.
    Returns the cache."""
    from repro_torch.models import layers, lm, transformer
    b, n = prompts.shape
    dev = prompts.device
    at = torch.tensor([n], device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with layers.count_moe_drops() as tally:
        cache = transformer.init_cache(cfg, b, n + 1, device=dev)
        cache, plog = lm.make_prefill(cfg, n + 1)(pc, cache, prompts)
        if last is None:
            last = plog.argmax(-1).to(prompts.dtype)
        # the decode step's token, then its logits (what it computes before
        # the argmax); the second write of position n's keys is the same
        cache, nxt = lm.make_decode_step(cfg)(pc, cache, last, at)
        h, cache, _ = transformer.forward(cfg, pc, last[:, None], at,
                                          caches=cache)
        step = transformer.lm_head(cfg, pc, h)[:, 0, :cfg.vocab]
        hf = transformer.forward(cfg, pc, torch.cat([prompts, last[:, None]],
                                                    dim=1),
                                 torch.arange(n + 1, device=dev))[0]
        full = transformer.lm_head(cfg, pc, hf[:, -1:])[:, 0, :cfg.vocab]
        torch.cuda.synchronize()
    launched = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    rel = float((step - full).abs().max() / full.abs().max())
    agree = int((step.argmax(-1) == full.argmax(-1)).sum())
    width = cache["k"].shape[3]
    print(f"lmserve {tag}: {cfg.name} B {b}, prefill {n} tokens into a "
          f"{width}-slot ring, decode at position {n} vs the cache-free "
          f"forward ({cfg.attention_impl}): max |d logits| / max |logit| = "
          f"{rel:.3e} (max |logit| {float(full.abs().max()):.3f}); greedy "
          f"tokens agree {agree}/{b}; dropped {tally.dropped} of "
          f"{tally.assigned} MoE assignments; peak {peak / 2**30:.2f} GiB")
    check(bool(((nxt >= 0) & (nxt < cfg.vocab)).all()),
          f"lmserve {tag}: a token outside [0, vocab)")
    check(peak < 80e9, f"lmserve {tag}: peak {peak / 1e9:.1f} GB >= 80 GB")
    check(bool(torch.isfinite(step).all() and torch.isfinite(full).all()),
          f"lmserve {tag}: non-finite logits")
    check(rel <= SERVE_LOGIT_TOL,
          f"lmserve {tag}: decode logits differ from the cache-free "
          f"forward by {rel:.3e} > {SERVE_LOGIT_TOL}")
    check(bool((nxt == step.argmax(-1)).all()),
          f"lmserve {tag}: decode_step's token is not its logits' argmax")
    check(tally.dropped == 0, f"lmserve {tag}: the dispatch dropped "
          f"{tally.dropped} assignments")
    check(not any(launched.values()),
          f"lmserve {tag}: a kernel launched on the serve path: {launched}")
    return cache


def profile_decode(torch, cfg, out: dict, tag: str, steps: int = 8) -> None:
    """Device time by kernel over ``steps`` decode steps from the serve
    run's final cache, and the card's idle share."""
    from repro_torch.models import lm
    pc, cache, b, pos0 = out["pc"], out["cache"], out["b"], out["pos0"]
    dev = pc.embed["tok"].device
    decode = lm.make_decode_step(cfg)
    tok = torch.zeros(b, dtype=torch.int32, device=dev)
    pos = torch.arange(pos0, pos0 + steps, device=dev)

    def run():
        nonlocal cache
        t = tok
        for i in range(steps):
            cache, t = decode(pc, cache, t, pos[i])
        return t

    # positions go on past max_len: the ring wraps, the work per step is
    # the same
    run()                                                   # warm
    _, wall, busy, rows = _profile(torch, run)
    n_kernels = sum(r[1] for r in rows)
    print(f"profile: {tag} decode, {steps} steps, wall "
          f"{1e3 * wall / steps:.3f} ms/step (profiled), device busy "
          f"{1e3 * busy / steps:.3f} ms/step, idle share "
          f"{1.0 - busy / wall:.3f}, {n_kernels / steps:.0f} kernels/step")
    for secs, n, key in rows[:12]:
        print(f"  {100 * secs / wall:5.1f}% {1e3 * secs / steps:7.3f} "
              f"ms/step x{n // steps:<4d}/step {key[:90]}")


def lmserve_phase(torch, dev, ops, lm_state: dict, profile: bool) -> None:
    """(a) danube serving, (b) the ring past its width, (c) OLMoE serving
    and its drop-free cross-check; the lm phase's model is reused for
    danube (the same seeded weights) and freed before OLMoE's."""
    from repro_torch import configs
    from repro_torch.models import layers, transformer
    cfg = configs.get(LM_ARCH)                     # "chunked" attention
    model = lm_state.pop("model", None)
    if model is None:
        model = transformer.init_params(cfg, seed=0, device=dev)
    lm_state.clear()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = serve_lm(torch, ops, cfg, model, SERVE_LM_B, SERVE_LM_PROMPT,
                   SERVE_LM_GEN, "lmserve (a)")
    if profile:
        profile_decode(torch, cfg, out, "lmserve (a)")
    pc = out["pc"]
    del out
    torch.cuda.empty_cache()
    print(f"lmserve (a): part wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    toks = lm_prompts(torch, cfg, RING_B, RING_PROMPT + 1, seed=2, dev=dev)
    cache = serve_vs_forward(torch, ops, cfg, pc, toks[:, :-1], toks[:, -1],
                             "(b)")
    held = cache["pos"][0]
    check(cache["k"].shape[3] == cfg.window
          and sorted(held.tolist()) == list(range(RING_PROMPT + 1
                                                   - cfg.window,
                                                   RING_PROMPT + 1)),
          "lmserve (b): the ring does not hold the last window positions")
    del model, pc, cache
    torch.cuda.empty_cache()
    print(f"lmserve (b): part wall {time.perf_counter() - t0:.1f} s")

    cfg = configs.get(OLMOE_ARCH)
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_experts}"
          f" experts top-{cfg.top_k} (d_ff {cfg.d_ff_expert}), heads "
          f"{cfg.n_heads}/{cfg.n_kv}, vocab {cfg.vocab}: {n_params / 1e9:.3f}e9"
          f" {cfg.param_dtype} parameters drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    # the config counts the vocab rows, the model holds the padded rows
    pad = (cfg.vocab_pad - cfg.vocab) * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    check(n_params == cfg.param_count() + pad + 2 * cfg.n_layers
          * cfg.d_model + cfg.d_model,
          "OLMoE's parameter count differs from the config's")
    out = serve_lm(torch, ops, cfg, model, OLMOE_B, OLMOE_PROMPT, OLMOE_GEN,
                   "lmserve (c)")
    if profile:
        profile_decode(torch, cfg, out, "lmserve (c)")
    pc = out["pc"]
    del out
    torch.cuda.empty_cache()
    # the cached path sees other token counts than the cache-free forward
    # (512, then 1, against 513), so at the config's capacity factor they
    # drop other assignments; at n_experts / top_k every expert holds
    # every token and nothing can drop
    prompt = lm_prompts(torch, cfg, 1, OLMOE_CROSS, seed=3, dev=dev)
    with layers.count_moe_drops() as tally:
        transformer.forward(cfg, pc, prompt,
                            torch.arange(OLMOE_CROSS, device=dev))
    print(f"lmserve (c) cross-check: at the config's capacity factor "
          f"{cfg.capacity_factor} the prompt's cache-free forward drops "
          f"{tally.dropped} of {tally.assigned} assignments; the cross-check "
          f"runs at {cfg.n_experts // cfg.top_k}")
    serve_vs_forward(torch, ops, cfg.with_(
        capacity_factor=cfg.n_experts / cfg.top_k), pc, prompt, None,
        "(c) cross-check")
    del model, pc
    torch.cuda.empty_cache()
    print(f"lmserve (c): part wall {time.perf_counter() - t0:.1f} s "
          f"(the weights' draw included)")


# ---------------------------------------------------------------------------
# the zoo phase: Zamba2 (hybrid), Mamba2 (SSM), Whisper (enc-dec)
# ---------------------------------------------------------------------------

def zoo_model(torch, cfg, dev, max_len: int = 0):
    """Seeded random weights on the card; the parameter count held
    against the config's (plus the norms, biases, positions and padded
    vocab rows it leaves out, counted from the schema)."""
    from repro_torch.models import transformer
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, seed=0, max_len=max_len,
                                    device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    schema = transformer.model_schema(cfg, max_len)
    want = sum(int(np.prod(shape)) for group in schema.values()
               for shape, _, _ in group.values())
    print(f"{cfg.name}: {cfg.family}, {cfg.n_layers} layers"
          + (f" + {cfg.n_enc_layers} encoder" if cfg.enc_dec else "")
          + f", d {cfg.d_model}: {n_params / 1e9:.3f}e9 {cfg.param_dtype} "
          f"parameters (config's count {cfg.param_count() / 1e9:.3f}e9) "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    check(n_params == want, f"{cfg.name}: {n_params} parameters, the "
          f"schema has {want}")
    return model


def zoo_frames(torch, cfg, b: int, seed: int, dev):
    """Seeded stub frames (b, enc_len, d) in the compute dtype, or None."""
    if not cfg.enc_dec:
        return None
    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        rng.standard_normal((b, cfg.enc_len, cfg.d_model), np.float32),
        device=dev).to(getattr(torch, cfg.dtype))


def zoo_loss(torch, ops, cfg, model, b: int, length: int, n: int,
             tag: str) -> None:
    """``lm.loss_fn`` on ``n`` seeded batches (Whisper's with seeded
    frames): wall per batch, tokens/s, peak; the loss finite within 1.0
    of ln V, no kernel launched."""
    from repro_torch.models import lm
    dev = next(model.parameters()).device
    batches = [tuple(torch.as_tensor(a, device=dev) for a in bt)
               for bt in lm_batches(cfg, n, b, length, seed=4)]
    frames = zoo_frames(torch, cfg, b, seed=5, dev=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ln_v = float(np.log(cfg.vocab))
    for i, (tokens, targets) in enumerate(batches):
        t0 = time.perf_counter()
        total, aux = lm.loss_fn(cfg, model, lm.Batch(tokens, targets,
                                                     frames))
        loss = float(aux["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"zoo {tag} loss batch {i}: {cfg.name} {b} x {length} tokens,"
              f" loss {loss:.6f} (ln V = {ln_v:.6f}), wall "
              f"{1e3 * wall:.1f} ms, {b * length / wall:.0f} tokens/s")
        check(np.isfinite(loss) and abs(loss - ln_v) < 1.0,
              f"zoo {tag}: loss {loss} is not finite within 1.0 of ln V")
        check(float(total) == loss, f"zoo {tag}: total != loss")
    peak = torch.cuda.max_memory_allocated()
    launched = dict(ops.LAUNCHES)
    print(f"zoo {tag} loss: peak {peak / 2**30:.2f} GiB, kernel-4 launches "
          f"{launched['flash_attention']}")
    check(peak < 80e9, f"zoo {tag}: loss peak {peak / 1e9:.1f} GB")
    check(not any(launched.values()),
          f"zoo {tag}: a kernel launched on the loss path: {launched}")


def decode_and_forward(torch, ops, cfg, model, length: int, dt: str):
    """ZOO_CROSS_B seeded prompts of ``length`` tokens prefilled in
    ``dt``, then one decode step at position ``length`` (its logits from
    ``forward`` with the cache, once: the SSM state is not idempotent
    under a second feed), and the cache-free forward over the ``length +
    1`` tokens at the last position.  Returns (decode logits, forward
    logits, ``make_decode_step``'s token, kernel launches, peak bytes);
    the weights cast to ``dt`` are freed before it returns."""
    from repro_torch.models import lm, transformer
    dev = next(model.parameters()).device
    toks = lm_prompts(torch, cfg, ZOO_CROSS_B, length + 1, seed=3, dev=dev)
    prompts, last = toks[:, :-1], toks[:, -1]
    at = torch.tensor([length], device=dev)
    c = cfg.with_(dtype=dt)
    pc = lm.cast_params(c, model)
    frames = zoo_frames(torch, c, ZOO_CROSS_B, seed=6, dev=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    cache = transformer.init_cache(c, ZOO_CROSS_B, length + 1, device=dev)
    cache, _ = lm.make_prefill(c, length + 1)(pc, cache, prompts, frames)
    snap = {}
    for path, t in cache_leaves(cache):
        node = snap
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t.clone()
    h, cache, _ = transformer.forward(c, pc, last[:, None], at, caches=cache)
    step = transformer.lm_head(c, pc, h)[:, 0, :c.vocab]
    _, nxt = lm.make_decode_step(c)(pc, snap, last, at)
    del cache, snap, h
    hf = transformer.forward(c, pc, toks, torch.arange(length + 1,
                                                       device=dev),
                             enc_frames=frames)[0]
    full = transformer.lm_head(c, pc, hf[:, -1:])[:, 0, :c.vocab]
    torch.cuda.synchronize()
    launched = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    del pc, hf
    torch.cuda.empty_cache()
    return step, full, nxt, launched, peak


def zoo_vs_forward(torch, ops, cfg, model, length: int, tag: str) -> None:
    """:func:`decode_and_forward` in bf16 and in f32 on the master
    weights: max |d logits| / max |logit| within SERVE_LOGIT_TOL (bf16)
    and ZOO_F32_TOL (f32), greedy tokens compared, ``make_decode_step``'s
    token its logits' argmax, no kernel launched."""
    for dt, tol in (("bfloat16", SERVE_LOGIT_TOL), ("float32", ZOO_F32_TOL)):
        step, full, nxt, launched, peak = decode_and_forward(
            torch, ops, cfg, model, length, dt)
        rel = float((step - full).abs().max() / full.abs().max())
        agree = int((step.argmax(-1) == full.argmax(-1)).sum())
        print(f"zoo {tag} cross-check ({dt}): {cfg.name} {cfg.n_layers} "
              f"layers, B {ZOO_CROSS_B}, prefill {length} tokens, decode at "
              f"position {length} vs the cache-free forward: max |d logits|"
              f" / max |logit| = {rel:.3e} (max |logit| "
              f"{float(full.abs().max()):.3f}); greedy tokens agree "
              f"{agree}/{ZOO_CROSS_B}; peak {peak / 2**30:.2f} GiB; "
              f"kernel-4 launches {launched['flash_attention']}")
        check(bool(torch.isfinite(step).all() and torch.isfinite(full).all()),
              f"zoo {tag}: non-finite logits")
        check(rel <= tol, f"zoo {tag} ({dt}): decode logits differ from the "
              f"cache-free forward by {rel:.3e} > {tol}")
        check(agree == ZOO_CROSS_B, f"zoo {tag} ({dt}): greedy tokens differ")
        check(bool((nxt == step.argmax(-1)).all()),
              f"zoo {tag} ({dt}): decode_step's token is not its logits' "
              f"argmax")
        check(not any(launched.values()),
              f"zoo {tag}: a kernel launched: {launched}")


def zoo_full_depth(torch, ops, cfg, model, length: int, tag: str) -> None:
    """The cross-check at ``cfg``'s full depth (ROADMAP C2): the decode
    step's logits against the cache-free forward's, f32 within
    ZOO_F32_TOL of max |logit| and its greedy tokens equal; bf16 within
    SERVE_LOGIT_TOL, or else its distance from the f32 forward within
    ZOO_BF16_RATIO times the bf16 forward's own, a greedy token flipped
    only where the f32 forward's top-2 margin is inside that own error;
    ``make_decode_step``'s token its logits' argmax, no kernel launched.
    bf16 runs first: its cast weights are freed before f32 runs on the
    master weights.  The f32 check decides: with random weights over 81
    layers the bf16 forward's own error is of the order of max |logit|
    (6.9e-1 on an H100), so the ratio rule then holds bf16 only loosely
    and is printed as informational."""
    t0 = time.perf_counter()
    got = {}
    for dt in ("bfloat16", "float32"):
        step, full, nxt, launched, peak = decode_and_forward(
            torch, ops, cfg, model, length, dt)
        check(bool(torch.isfinite(step).all() and torch.isfinite(full).all()),
              f"zoo {tag} full depth ({dt}): non-finite logits")
        check(bool((nxt == step.argmax(-1)).all()),
              f"zoo {tag} full depth ({dt}): decode_step's token is not its "
              f"logits' argmax")
        check(not any(launched.values()),
              f"zoo {tag} full depth: a kernel launched: {launched}")
        got[dt] = (step.float(), full.float(), peak)
    step32, full32, peak32 = got["float32"]
    step16, full16, peak16 = got["bfloat16"]
    scale = float(full32.abs().max())
    rel32 = float((step32 - full32).abs().max()) / scale
    rel16 = float((step16 - full16).abs().max() / full16.abs().max())
    own = float((full16 - full32).abs().max()) / scale
    dist = float((step16 - full32).abs().max()) / scale
    top = full32.topk(2, dim=-1).values
    margin = (top[:, 0] - top[:, 1]) / scale
    agree32 = step32.argmax(-1) == full32.argmax(-1)
    flips = step16.argmax(-1) != full32.argmax(-1)
    print(f"zoo {tag} full depth: {cfg.name} {cfg.n_layers} layers, B "
          f"{ZOO_CROSS_B}, prefill {length} tokens, decode at position "
          f"{length} vs the cache-free forward: f32 max |d logits| / max "
          f"|logit| = {rel32:.3e} (max |logit| {scale:.3f}), greedy tokens "
          f"agree {int(agree32.sum())}/{ZOO_CROSS_B}; bf16 {rel16:.3e}, "
          f"bf16 decode vs f32 forward {dist:.3e}, bf16 forward's own error "
          f"vs f32 forward {own:.3e} (ratio {dist / own:.2f}), bf16 greedy "
          f"tokens off the f32 forward's {int(flips.sum())}/{ZOO_CROSS_B} "
          f"(top-2 margins {[round(float(m), 6) for m in margin]}); peak "
          f"{peak16 / 2**30:.2f} / {peak32 / 2**30:.2f} GiB (bf16 / f32); "
          f"wall {time.perf_counter() - t0:.1f} s")
    if rel16 > SERVE_LOGIT_TOL:
        print(f"zoo {tag} full depth (bf16): informational only: the bf16 "
              f"forward is itself {own:.3e} of max |logit| from the f32 "
              f"forward, so the {ZOO_BF16_RATIO}x rule passes anything "
              f"within {ZOO_BF16_RATIO * own:.3e}; the f32 check decides")
    check(rel32 <= ZOO_F32_TOL, f"zoo {tag} full depth (f32): decode logits "
          f"differ from the cache-free forward by {rel32:.3e} > "
          f"{ZOO_F32_TOL}")
    check(bool(agree32.all()), f"zoo {tag} full depth (f32): greedy tokens "
          f"differ")
    check(rel16 <= SERVE_LOGIT_TOL or dist <= ZOO_BF16_RATIO * own,
          f"zoo {tag} full depth (bf16): decode logits {rel16:.3e} from the "
          f"bf16 forward (> {SERVE_LOGIT_TOL}) and {dist:.3e} from the f32 "
          f"forward, > {ZOO_BF16_RATIO} x the bf16 forward's own {own:.3e}")
    check(not bool((flips & (margin > own)).any()),
          f"zoo {tag} full depth (bf16): a greedy token flipped beyond the "
          f"bf16 forward's own error")


def zoo_phase(torch, dev, ops, profile: bool) -> None:
    """(a) Zamba2-7B at full width and depth: ``loss_fn``, serving, the
    cross-check at a ZAMBA_CUT-layer cut and at full depth; (b) Mamba2-130M serving and its
    cross-check; (c) Whisper-small serving and its cross-check.  No
    kernel runs on these paths (the reference routes none of them
    through flash attention)."""
    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = configs.get(ZAMBA_ARCH)
    t0 = time.perf_counter()
    model = zoo_model(torch, cfg, dev)
    zoo_loss(torch, ops, cfg, model, ZAMBA_LOSS_B, ZAMBA_LOSS_L,
             ZAMBA_LOSS_BATCHES, "(a)")
    torch.cuda.empty_cache()
    out = serve_lm(torch, ops, cfg, model, ZAMBA_B, ZAMBA_PROMPT, ZAMBA_GEN,
                   "zoo (a)")
    if profile:
        profile_decode(torch, cfg, out, "zoo (a)")
    del out
    torch.cuda.empty_cache()
    cut = cfg.with_(n_layers=ZAMBA_CUT)
    tree = model.tree()
    small = transformer.DecoderLM(cut, {**tree,
                                        "blocks": tree["blocks"][:ZAMBA_CUT]})
    zoo_vs_forward(torch, ops, cut, small, ZOO_CROSS_PROMPT, "(a)")
    del tree, small
    torch.cuda.empty_cache()
    zoo_full_depth(torch, ops, cfg, model, ZOO_CROSS_PROMPT, "(a)")
    del model
    torch.cuda.empty_cache()
    print(f"zoo (a): part wall {time.perf_counter() - t0:.1f} s")

    for tag, arch, b, prompt, gen, max_len, cross in (
            ("(b)", MAMBA_ARCH, MAMBA_B, MAMBA_PROMPT, MAMBA_GEN, 0,
             ZOO_CROSS_PROMPT),
            ("(c)", WHISPER_ARCH, WHISPER_B, WHISPER_PROMPT, WHISPER_GEN,
             WHISPER_CTX, WHISPER_CTX - 1)):
        cfg = configs.get(arch)
        t0 = time.perf_counter()
        model = zoo_model(torch, cfg, dev, max_len=max_len)
        zoo_loss(torch, ops, cfg, model, b, max_len or prompt, 1, tag)
        out = serve_lm(torch, ops, cfg, model, b, prompt, gen, f"zoo {tag}",
                       zoo_frames(torch, cfg, b, seed=2, dev=dev))
        if profile:
            profile_decode(torch, cfg, out, f"zoo {tag}")
        del out
        torch.cuda.empty_cache()
        zoo_vs_forward(torch, ops, cfg, model, cross, tag)
        del model
        torch.cuda.empty_cache()
        print(f"zoo {tag}: part wall {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the train phase: the LM train step (AdamW, micro-batches, remat, the
# chunked attention's backward, checkpoint and resume)
# ---------------------------------------------------------------------------

def train_flops(cfg, b: int, length: int) -> tuple[float, float]:
    """(model flops of one train step, of which attention): 6 N per token
    (N the parameters less the input embedding, a lookup) and 12 hd H per
    visible (query, key) pair per layer (QK^T and PV, forward and
    backward), the pairs of this run's causal window, not L^2."""
    n = cfg.param_count() - cfg.vocab * cfg.d_model
    w = cfg.window or length
    pos = np.arange(length)
    pairs = int((pos - np.maximum(pos - w + 1, 0) + 1).sum())
    attn = 12.0 * cfg.hd * cfg.n_heads * pairs * cfg.n_layers * b
    return 6.0 * n * b * length + attn, attn


def train_run(torch, cfg, dev, b: int, length: int, steps: int, tag: str,
              ops):
    """``train()`` of ``cfg`` at full width and depth for ``steps`` steps
    of (b, length) tokens on seeded random weights: per step wall,
    tokens/s, loss, grad norm and lr; the peak; no kernel launched; the
    losses finite.  Returns (result, peak bytes)."""
    from repro_torch.models import lm, transformer
    from repro_torch.train import optim
    from repro_torch.train.loop import TrainerConfig, train
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, max_len=length, device=dev)
    state = lm.init_train_state(params, optim.AdamW(weight_decay=0.1,
                                                    clip_norm=1.0))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    print(f"train {tag}: {cfg.name} {cfg.n_layers} layers, d {cfg.d_model},"
          f" {n / 1e9:.3f}e9 f32 parameters + AdamW moments on the card in "
          f"{time.perf_counter() - t0:.1f} s; remat {cfg.remat} "
          f"(group {cfg.remat_group}), n_micro {cfg.n_micro}, attention "
          f"{cfg.attention_impl}, compute {cfg.dtype}")
    tc = TrainerConfig(seq_len=length, global_batch=b, n_micro=cfg.n_micro,
                       steps=steps, log_every=0)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = train(cfg, tc, state=state, log=print, device=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launched = dict(ops.LAUNCHES)
    for i, (loss, wall, m) in enumerate(zip(res.losses, res.step_s,
                                            res.metrics)):
        print(f"train {tag} step {i}: wall {wall:.3f} s "
              f"({'first' if i == 0 else 'warm'}), "
              f"{b * length / wall:.0f} tokens/s, loss {loss:.6f}, grad "
              f"norm {float(m['grad_norm']):.4f}, lr {float(m['lr']):.3e}")
    print(f"train {tag}: peak {peak / 2**30:.2f} GiB, kernel-4 launches "
          f"{launched['flash_attention']}")
    check(res.final_step == steps and len(res.losses) == steps,
          f"train {tag}: {res.final_step} steps of {steps}")
    check(all(np.isfinite(x) for x in res.losses),
          f"train {tag}: a loss is not finite: {res.losses}")
    check(peak < 80e9, f"train {tag}: peak {peak / 1e9:.1f} GB >= 80 GB")
    check(not any(launched.values()),
          f"train {tag}: a kernel launched: {launched}")
    return res, peak


def train_grad_check(torch, cfg0, params) -> None:
    """The trained weights cut to GRAD_LAYERS layers in f32: ``loss_fn``'s
    gradients at GRAD_B x GRAD_L through the chunked attention (its
    custom backward) against the "ref" route (the materialised softmax,
    plain autograd), every leaf within GRAD_TOL of its max |g|."""
    from repro_torch.models import lm, transformer
    from repro_torch.train import optim
    tree = params.tree()
    (tokens, targets), = lm_batches(cfg0, 1, GRAD_B, GRAD_L, seed=9)
    dev = tree["embed"]["tok"].device
    batch = lm.Batch(torch.as_tensor(tokens, device=dev),
                     torch.as_tensor(targets, device=dev))
    grads = {}
    for impl in ("chunked", "ref"):
        cfg = cfg0.with_(n_layers=GRAD_LAYERS, attention_impl=impl,
                         dtype="float32", remat=False, n_micro=1)
        cut = transformer.DecoderLM(cfg, {**tree, "blocks":
                                          tree["blocks"][:GRAD_LAYERS]})
        cut.requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (loss, _), g = optim.accumulate_gradients(
            lambda p, bt: lm.loss_fn(cfg, p, bt), cut, batch, 1)
        torch.cuda.synchronize()
        print(f"train (b) {impl}: {GRAD_LAYERS} layers f32, {GRAD_B} x "
              f"{GRAD_L}: loss {float(loss):.6f}, wall "
              f"{time.perf_counter() - t0:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        grads[impl] = optim.tree_leaves(g)
        del cut, g
    worst = 0.0
    for a, r in zip(grads["chunked"], grads["ref"]):
        scale = float(r.abs().max())
        worst = max(worst, float((a - r).abs().max()) / max(scale, 1e-30))
    print(f"train (b): {len(grads['ref'])} leaves, max over leaves of "
          f"max |g_chunked - g_ref| / max |g_ref| = {worst:.3e} "
          f"(tolerance {GRAD_TOL})")
    check(worst <= GRAD_TOL, f"train (b): the chunked backward differs "
          f"from the ref route by {worst:.3e} of a leaf's max |g|")


def train_example(torch, dev) -> None:
    """examples/torch_lm_train.py at its size (300 steps, its gate), its
    checkpoints under TRAIN_DIR; the step-300 checkpoint restored into a
    fresh state equals the run's final state bit for bit; RESUME_STEPS
    steps resumed from the step-RESUME_FROM checkpoint (the loop's own
    step, schedule and data source) against the first run's losses."""
    from repro_torch import convert
    from repro_torch.models import lm, transformer
    from repro_torch.train import checkpoint as ckpt, optim
    from repro_torch.train.data import make_source
    ex = load_example("torch_lm_train")
    out = TRAIN_DIR / "example"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    res = ex.main(["--ckpt-dir", str(out)], device=dev)
    wall = time.perf_counter() - t0
    cfg = ex.model_config()
    tc = ex.trainer_config(res.final_step, str(out))
    warm = np.asarray(res.step_s[1:])
    print(f"train (c): {cfg.name} {res.final_step} steps of "
          f"{tc.global_batch} x {tc.seq_len} in {wall:.1f} s (checkpoints "
          f"included), warm step mean {1e3 * warm.mean():.1f} ms p50 "
          f"{1e3 * np.median(warm):.1f} ms, loss {res.losses[0]:.4f} -> "
          f"{res.losses[-1]:.4f} (drop {res.losses[0] - res.losses[-1]:.4f})"
          f"; checkpoints {sorted(os.listdir(out))}")
    check(res.losses[-1] < res.losses[0] - 0.5, "train (c): no 0.5 drop")

    def fresh():
        return lm.init_train_state(
            transformer.init_params(cfg, seed=1, max_len=tc.seq_len,
                                    device=dev), optim.AdamW())
    back, manifest = ckpt.restore(str(out), fresh(), step=res.final_step)
    mine = optim.tree_leaves(convert.train_state_to_numpy(res.state))
    theirs = optim.tree_leaves(convert.train_state_to_numpy(back))
    same = len(mine) == len(theirs) and all(
        a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(mine, theirs))
    print(f"train (c): step-{manifest['step']} checkpoint restored, "
          f"{len(mine)} leaves, bit-equal to the run's state: {same}")
    check(same, "train (c): the restored checkpoint differs from the state")

    state, _ = ckpt.restore(str(out), fresh(), step=RESUME_FROM)
    opt = optim.AdamW(weight_decay=0.1, clip_norm=1.0)
    step = lm.make_train_step(cfg, opt, optim.cosine_schedule(
        tc.peak_lr, tc.warmup, tc.steps), n_micro=tc.n_micro)
    source = make_source(cfg, tc.seq_len, tc.global_batch, tc.seed, dev)
    again = []
    for s in range(RESUME_FROM, RESUME_FROM + RESUME_STEPS):
        state, m = step(state, source(s))
        again.append(float(m["loss"]))
    first = res.losses[RESUME_FROM:RESUME_FROM + RESUME_STEPS]
    gap = float(np.abs(np.asarray(again) - np.asarray(first)).max())
    print(f"train (c): resumed at step {RESUME_FROM} for {RESUME_STEPS} "
          f"steps: max |loss - first run's| = {gap:.3e}")
    check(gap <= RESUME_TOL, f"train (c): resume differs by {gap:.3e}")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def profile_train(torch, cfg, res) -> None:
    """Device time by kernel over one more warm step of (a), and the
    card's idle share."""
    from repro_torch.models import lm
    from repro_torch.train import optim
    from repro_torch.train.data import make_source
    step = lm.make_train_step(cfg, optim.AdamW(weight_decay=0.1,
                                               clip_norm=1.0),
                              lambda s: 1e-5, n_micro=cfg.n_micro)
    dev = res.state.step.device
    batch = make_source(cfg, TRAIN_L, TRAIN_B, 0, dev)(TRAIN_STEPS)
    _, wall, busy, rows = _profile(torch, lambda: step(res.state, batch))
    print(f"profile: train step {TRAIN_B} x {TRAIN_L} wall={wall:.3f} s "
          f"(profiled), device busy {busy:.3f} s, idle share "
          f"{1.0 - busy / wall:.3f}")
    for secs, n, key in rows[:20]:
        print(f"  {100 * secs / wall:5.1f}% {1e3 * secs:9.2f} ms x{n:<6d} "
              f"{key[:90]}")


def train_phase(torch, dev, ops, profile: bool) -> list:
    """(a) danube at full width and depth, ``train()`` for TRAIN_STEPS
    steps; (b) the chunked backward against the ref route; (c) the
    example, its checkpoint and a resume; (d) Mamba2 and Whisper at full
    width, FAMILY_STEPS steps each.  Returns (a)'s losses."""
    from repro_torch import configs
    cfg = configs.get(TRAIN_ARCH)
    t0 = time.perf_counter()
    res, peak = train_run(torch, cfg, dev, TRAIN_B, TRAIN_L, TRAIN_STEPS,
                          "(a)", ops)
    flops, attn = train_flops(cfg, TRAIN_B, TRAIN_L)
    warm = float(np.median(res.step_s[1:]))
    print(f"train (a): model flops per step {flops:.4e} (attention "
          f"{attn:.3e}); warm step {warm:.3f} s = {flops / warm / 1e12:.1f} "
          f"TFLOP/s = {100 * flops / warm / PEAK_FLOPS['bfloat16']:.2f}% of "
          f"the {PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s bf16 peak; "
          f"{TRAIN_B * TRAIN_L / warm:.0f} tokens/s; peak "
          f"{peak / 2**30:.2f} GiB")
    if profile:
        profile_train(torch, cfg, res)
    params, losses = res.state.params, res.losses
    del res
    torch.cuda.empty_cache()
    train_grad_check(torch, cfg, params)
    del params
    torch.cuda.empty_cache()
    print(f"train (a)+(b): part wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_example(torch, dev)
    torch.cuda.empty_cache()
    print(f"train (c): part wall {time.perf_counter() - t0:.1f} s")
    for arch, b, length in FAMILY_TRAIN:
        t0 = time.perf_counter()
        train_run(torch, configs.get(arch), dev, b, length, FAMILY_STEPS,
                  "(d)", ops)
        torch.cuda.empty_cache()
        print(f"train (d) {arch}: part wall {time.perf_counter() - t0:.1f} s")
    return losses


# ---------------------------------------------------------------------------
# phase 15: multi-rank training
# ---------------------------------------------------------------------------

def mp_train_config(steps: int, b: int, length: int, n_micro: int):
    from repro_torch.train.loop import TrainerConfig
    return TrainerConfig(seq_len=length, global_batch=b, n_micro=n_micro,
                         steps=steps, log_every=0)


def state_bytes(state) -> int:
    """Bytes of a train state's tensors on this rank (params, moments)."""
    from repro_torch.train import optim
    leaves = (optim.tree_leaves(state.params.tree())
              + optim.tree_leaves(state.opt.m) + optim.tree_leaves(
                  state.opt.v))
    return sum(t.numel() * t.element_size() for t in leaves)


def trainmp_world1(torch, dev, ops, want) -> None:
    """(a) ``train(mesh=)`` on the (1, 1) mesh of a one-rank NCCL group
    (every team of one rank: each collective the identity), held against
    the one-process losses ``want`` of the same seed, card and steps."""
    from repro_torch import configs
    from repro_torch.comm import group
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.loop import train
    cfg = configs.get(TRAIN_ARCH)
    tc = mp_train_config(TRAINMP_STEPS, TRAIN_B, TRAIN_L, cfg.n_micro)
    if want is None:
        torch.cuda.reset_peak_memory_stats()
        want = train(cfg, tc, log=print, device=dev).losses
        torch.cuda.empty_cache()
    want = list(want[:TRAINMP_STEPS])
    group.init_process_group(dev, world_size=1, rank=0,
                             init_method=f"tcp://localhost:{free_port()}")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        res = train(cfg, tc, mesh=mesh, log=print, device=dev)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launched = dict(ops.LAUNCHES)
        sb = state_bytes(res.state)
        del res.state
    finally:
        group.destroy_process_group()
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(res.losses, want))
    for i, (loss, wall) in enumerate(zip(res.losses, res.step_s)):
        print(f"trainmp (a) step {i}: wall {wall:.3f} s "
              f"({'first' if i == 0 else 'warm'}), "
              f"{TRAIN_B * TRAIN_L / wall:.0f} tokens/s, loss {loss:.6f} "
              f"(one process {want[i]:.6f})")
    print(f"trainmp (a): {cfg.name} on mesh (1, 1) of a one-rank NCCL "
          f"group, {TRAINMP_STEPS} step(s) of {TRAIN_B} x {TRAIN_L}: max "
          f"relative loss difference to one process {rel:.3e} (tolerance "
          f"{MP_W1_TOL}); state {sb / 2**30:.2f} GiB; peak "
          f"{peak / 2**30:.2f} GiB; kernel launches {launched}")
    check(rel <= MP_W1_TOL, f"trainmp (a): losses differ by {rel:.3e}")
    check(not any(launched.values()), "trainmp (a): a kernel launched")


def _moe_blocks(n: int):
    """``apply_moe`` with the reference's per-shard dispatch run in one
    process: the tokens in ``n`` contiguous blocks, each dispatched into
    its own capacity slice, the aux loss from the blocks' summed
    statistics (the semantics the ranks of a data team of ``n`` run
    between them)."""
    import torch
    from repro_torch.models import layers

    def apply_moe(cfg, p, x, prefix="moe"):
        b, length, d = x.shape
        t = b * length
        c_loc = layers.moe_capacity(cfg, t) // n
        parts = [layers._moe_dispatch_local(cfg, blk, p[f"{prefix}_router"],
                                            c_loc)
                 for blk in x.reshape(t, d).chunk(n)]
        me = sum(part[4][0] for part in parts)
        ce = sum(part[4][1] for part in parts)
        aux = cfg.n_experts * torch.sum((me / t) * (ce / t))
        outs = [layers._moe_experts(cfg, p, buf, slot, gates, keep, prefix,
                                    x.dtype)
                for buf, slot, gates, keep, _ in parts]
        return torch.cat(outs).reshape(b, length, d), aux

    return apply_moe


def mp_moe_reference(torch, dev, cfg, n: int) -> float:
    """The step-1 loss the ranks report for (c), in one process: the last
    micro-batch's ``loss_fn`` with the dispatch run block by block."""
    from repro_torch.models import layers, lm, transformer
    from repro_torch.train.data import make_source
    params = transformer.init_params(cfg, seed=0, max_len=MP_MOE_L,
                                     device=dev)
    batch = make_source(cfg, MP_MOE_L, MP_MOE_B, 0, dev)(0)
    micro = MP_MOE_B // MP_MOE_MICRO
    last = lm.Batch(batch.tokens[-micro:], batch.targets[-micro:])
    real = layers.apply_moe
    layers.apply_moe = _moe_blocks(n)
    try:
        with torch.no_grad():
            _, aux = lm.loss_fn(cfg, params, last)
    finally:
        layers.apply_moe = real
    return float(aux["loss"])


def _mp_watch(fn):
    """(fn(), watched wire bytes as a Fraction)."""
    from repro_torch.comm.group import set_collective_watcher
    seen = []
    prev = set_collective_watcher(lambda prim, axes, nb: seen.append(nb))
    try:
        out = fn()
    finally:
        set_collective_watcher(prev)
    return out, sum(seen, Fraction(0))


def _mp_train(torch, dev, cfg, shape, tc, tag):
    """``train(mesh=)`` on a (data, model) mesh of ``shape`` of the
    group's ranks: losses, step walls, state bytes, host copies and wire
    bytes per step, peak, MoE drops, the blocks of the first layer's
    ssm_out and of the attention's wq."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers
    from repro_torch.train.loop import train
    mesh = make_mesh(shape, ("data", "model"), device=dev)
    copies0 = mesh.host_copies
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with layers.count_moe_drops() as tally:
        res, wire = _mp_watch(lambda: train(cfg, tc, mesh=mesh,
                                            log=lambda *a: None, device=dev))
    torch.cuda.synchronize()
    block = res.state.params.blocks[0]
    # Zamba2's attention lives in its shared block
    attn = getattr(res.state.params, "shared", block)

    def shape_of(p, name):
        return tuple(p[name].shape) if name in p else None
    out = dict(tag=tag, losses=res.losses, step_s=res.step_s,
               grad_norm=[float(m["grad_norm"]) for m in res.metrics],
               state_bytes=state_bytes(res.state),
               copies=(mesh.host_copies - copies0) / tc.steps,
               wire=str(wire / tc.steps), coords=mesh.coords,
               peak=torch.cuda.max_memory_allocated(),
               dropped=tally.dropped, assigned=tally.assigned,
               wq=shape_of(attn, "attn_wq"),
               ssm_out=shape_of(block, "ssm_out"),
               experts=(block["moe_wg"].shape[0] if "moe_wg" in block
                        else 0))
    del res
    torch.cuda.empty_cache()
    return out


def _mp_collectives(torch, dev, world: int, n: int) -> dict:
    """(d) the int8 ring and the bf16 psum of ``n`` seeded float32 per
    rank on a one-axis mesh of the world: relative error to the exact
    sum, watched bytes, wall (after a warm-up call)."""
    from repro_torch.comm import collectives as cc
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world,), ("d",), device=dev)
    rank = mesh.rank

    def draw(r):
        gen = torch.Generator(device=dev).manual_seed(1000 + r)
        return torch.randn(n, generator=gen, device=dev)
    x = draw(rank)
    exact = sum(draw(r) for r in range(world))
    out = {}
    for name, fn in (
            ("ring", lambda: cc.ring_allreduce_int8(x, mesh, ("d",))),
            ("psum", lambda: cc.compressed_psum(
                {"g": x}, mesh, ("d",), method="bf16")[0]["g"])):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, wire = _mp_watch(fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rel = float((got - exact).abs().max() / exact.abs().max())
        out[name] = dict(rel=rel, wall=wall, wire=str(wire))
    return out


def _mp_families(configs):
    """(f), (g), (h): (key, config, mesh, train config) of the ssm, hybrid
    and audio families' runs."""
    ssm = configs.get(MP_SSM_ARCH).with_(n_layers=MP_SSM_LAYERS)
    hyb = configs.get(MP_HYB_ARCH).with_(n_layers=MP_HYB_LAYERS)
    aud = configs.get(MP_AUD_ARCH).with_(n_layers=MP_AUD_LAYERS,
                                          n_enc_layers=MP_AUD_LAYERS)
    return (("f", ssm, MP_SSM_MESH, mp_train_config(
                MP_SSM_STEPS, MP_SSM_B, MP_SSM_L, ssm.n_micro)),
            ("g", hyb, MP_HYB_MESH, mp_train_config(
                MP_HYB_STEPS, MP_HYB_B, MP_HYB_L, hyb.n_micro)),
            ("h", aud, MP_AUD_MESH, mp_train_config(
                MP_AUD_STEPS, MP_AUD_B, MP_AUD_L, aud.n_micro)))


def _trainmp_rank(rank, cfg, out_q):
    """One of ``cfg["world"]`` gloo ranks sharing ``cfg["device"]``: (b)
    the dense model on MP_DENSE_MESH, (c) the MoE on MP_MOE_MESH, (d) the
    collectives, (e) the MoE on MP_EP_MESH, (f), (g), (h) the ssm, hybrid
    and audio families (``_mp_families``)."""
    import datetime
    import traceback
    sys.path.insert(0, str(SRC))
    import torch
    from repro_torch import configs
    from repro_torch.comm import group
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = group.init_process_group(
            cfg["device"], backend="gloo", world_size=cfg["world"],
            rank=rank, init_method=f"file://{cfg['init_file']}",
            timeout=datetime.timedelta(seconds=600))
        dense = configs.get(TRAIN_ARCH).with_(n_layers=MP_DENSE_LAYERS)
        moe = configs.get(OLMOE_ARCH).with_(n_layers=MP_MOE_LAYERS)
        out = {
            "b": _mp_train(torch, dev, dense, MP_DENSE_MESH, mp_train_config(
                MP_DENSE_STEPS, TRAIN_B, TRAIN_L, dense.n_micro), "(b)"),
            "c": _mp_train(torch, dev, moe, MP_MOE_MESH, mp_train_config(
                MP_MOE_C_STEPS, MP_MOE_B, MP_MOE_L, MP_MOE_MICRO), "(c)"),
            "d": _mp_collectives(torch, dev, cfg["world"], MP_COLL_N),
            "e": _mp_train(torch, dev, moe, MP_EP_MESH, mp_train_config(
                MP_MOE_STEPS, MP_MOE_B, MP_MOE_L, MP_MOE_MICRO), "(e)")}
        for key, fam, shape, tc in _mp_families(configs):
            out[key] = _mp_train(torch, dev, fam, shape, tc, f"({key})")
        out_q.put((rank, True, out))
    except BaseException:
        out_q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        group.destroy_process_group()


def trainmp_ranks(torch, dev) -> None:
    """(b)-(h) on P_DIST gloo ranks sharing the card, each held against
    one process on the card (b, c, e-h) or the exact sum (d)."""
    from repro_torch import configs
    from repro_torch.core import costmodel
    from repro_torch.train.loop import train
    dense = configs.get(TRAIN_ARCH).with_(n_layers=MP_DENSE_LAYERS)
    moe = configs.get(OLMOE_ARCH).with_(n_layers=MP_MOE_LAYERS)
    tc = mp_train_config(MP_DENSE_STEPS, TRAIN_B, TRAIN_L, dense.n_micro)
    torch.cuda.reset_peak_memory_stats()
    one = train(dense, tc, log=lambda *a: None, device=dev)
    one_bytes, one_peak = state_bytes(one.state), \
        torch.cuda.max_memory_allocated()
    want_b, one_steps = one.losses, one.step_s
    del one
    torch.cuda.empty_cache()
    want_c = mp_moe_reference(torch, dev, moe, MP_MOE_MESH[0])
    torch.cuda.empty_cache()
    tc_e = mp_train_config(MP_MOE_STEPS, MP_MOE_B, MP_MOE_L, MP_MOE_MICRO)
    torch.cuda.reset_peak_memory_stats()
    one_e = train(moe, tc_e, log=lambda *a: None, device=dev)
    want_e, e_bytes, e_peak = (one_e.losses, state_bytes(one_e.state),
                               torch.cuda.max_memory_allocated())
    e_steps = one_e.step_s
    del one_e
    torch.cuda.empty_cache()
    one_fam = {}
    for key, fam, _, tc_fam in _mp_families(configs):
        torch.cuda.reset_peak_memory_stats()
        one_x = train(fam, tc_fam, log=lambda *a: None, device=dev)
        one_fam[key] = dict(losses=one_x.losses,
                            state=state_bytes(one_x.state),
                            peak=torch.cuda.max_memory_allocated(),
                            steps=one_x.step_s)
        del one_x
        torch.cuda.empty_cache()
    cfg = dict(device=str(dev), world=P_DIST, init_file=str(MP_DIR / "pg"))
    t0 = time.perf_counter()
    results = spawn_ranks(_trainmp_rank, cfg, "trainmp")
    print(f"trainmp: {P_DIST} gloo ranks on one card, (b)-(h) in "
          f"{time.perf_counter() - t0:.1f} s (process start included)")
    rows = [results[r] for r in range(P_DIST)]

    # (b) the dense model on (2, 2)
    b0 = rows[0]["b"]
    print(f"trainmp (b): {dense.name} at {MP_DENSE_LAYERS} layers on mesh "
          f"{MP_DENSE_MESH}, {MP_DENSE_STEPS} step(s) of {TRAIN_B} x "
          f"{TRAIN_L}"
          f", n_micro {dense.n_micro}; one process: state "
          f"{one_bytes / 2**30:.3f} GiB, peak {one_peak / 2**30:.2f} GiB, "
          f"steps {', '.join(f'{w:.3f}' for w in one_steps)} s")
    for i, want in enumerate(want_b):
        rel = max(abs(r["b"]["losses"][i] - want) / abs(want) for r in rows)
        tol = MP_STEP1_TOL if i == 0 else MP_LATER_TOL
        print(f"trainmp (b) step {i}: loss {b0['losses'][i]:.6f} vs one "
              f"process {want:.6f}: max relative {rel:.3e} (tolerance "
              f"{tol}); wall {max(r['b']['step_s'][i] for r in rows):.3f} s"
              f" (slowest rank)")
        check(rel <= tol, f"trainmp (b) step {i}: loss differs by {rel:.3e}")
    for r, row in enumerate(rows):
        b = row["b"]
        print(f"  rank {r} {b['coords']}: attn_wq "
              f"block {b['wq']}, state {b['state_bytes'] / 2**30:.3f} GiB "
              f"({b['state_bytes'] / one_bytes:.3f} of one process), gloo "
              f"host copies {b['copies']:.0f} and wire bytes "
              f"{float(Fraction(b['wire'])):.4e} per step, peak "
              f"{b['peak'] / 2**30:.2f} GiB")
        check(b["losses"] == b0["losses"], "trainmp (b): ranks disagree")
        check(b["wq"] == (dense.d_model // MP_DENSE_MESH[0],
                          dense.n_heads * dense.hd // MP_DENSE_MESH[1]),
              f"trainmp (b): attn_wq block {b['wq']}")

    # (c) the MoE on (4, 1): the per-shard dispatch
    c0 = rows[0]["c"]
    rel = abs(c0["losses"][0] - want_c) / abs(want_c)
    print(f"trainmp (c): {moe.name} at {MP_MOE_LAYERS} layer(s) on mesh "
          f"{MP_MOE_MESH}, {MP_MOE_C_STEPS} step(s) of {MP_MOE_B} x "
          f"{MP_MOE_L}, "
          f"n_micro {MP_MOE_MICRO}: step-1 loss {c0['losses'][0]:.6f} vs "
          f"one process dispatching {MP_MOE_MESH[0]} token blocks "
          f"{want_c:.6f}: relative {rel:.3e} (tolerance {MP_MOE_TOL}); "
          f"losses {[round(x, 6) for x in c0['losses']]}")
    for r, row in enumerate(rows):
        c = row["c"]
        print(f"  rank {r} {c['coords']}: steps "
              f"{', '.join(f'{w:.3f}' for w in c['step_s'])} s, dropped "
              f"{c['dropped']} of {c['assigned']} assignments, state "
              f"{c['state_bytes'] / 2**30:.3f} GiB, gloo host copies "
              f"{c['copies']:.0f} and wire bytes "
              f"{float(Fraction(c['wire'])):.4e} per step, peak "
              f"{c['peak'] / 2**30:.2f} GiB")
        check(c["losses"] == c0["losses"], "trainmp (c): ranks disagree")
    check(rel <= MP_MOE_TOL, f"trainmp (c): step-1 loss differs by {rel:.3e}")

    # (e) the MoE on (1, 4): each rank its share of the experts
    e0 = rows[0]["e"]
    print(f"trainmp (e): {moe.name} at {MP_MOE_LAYERS} layer(s) on mesh "
          f"{MP_EP_MESH}, {MP_MOE_STEPS} steps of "
          f"{MP_MOE_B} x {MP_MOE_L}, n_micro {MP_MOE_MICRO}; one process: "
          f"state {e_bytes / 2**30:.3f} GiB, peak {e_peak / 2**30:.2f} GiB, "
          f"steps {', '.join(f'{w:.3f}' for w in e_steps)} s")
    for i, want in enumerate(want_e):
        rel = max(abs(r["e"]["losses"][i] - want) / abs(want) for r in rows)
        tol = MP_STEP1_TOL if i == 0 else MP_LATER_TOL
        print(f"trainmp (e) step {i}: loss {e0['losses'][i]:.6f} vs one "
              f"process {want:.6f}: max relative {rel:.3e} (tolerance "
              f"{tol}); wall {max(r['e']['step_s'][i] for r in rows):.3f} s"
              f" (slowest rank)")
        check(rel <= tol, f"trainmp (e) step {i}: loss differs by {rel:.3e}")
    for r, row in enumerate(rows):
        e = row["e"]
        print(f"  rank {r} {e['coords']}: {e['experts']} of "
              f"{moe.n_experts} experts, state "
              f"{e['state_bytes'] / 2**30:.3f} GiB "
              f"({e['state_bytes'] / e_bytes:.3f} of one process), gloo "
              f"host copies {e['copies']:.0f} and wire bytes "
              f"{float(Fraction(e['wire'])):.4e} per step, peak "
              f"{e['peak'] / 2**30:.2f} GiB")
        check(e["losses"] == e0["losses"], "trainmp (e): ranks disagree")
        check(e["experts"] == moe.n_experts // MP_EP_MESH[1],
              f"trainmp (e): {e['experts']} experts")

    for key, fam, shape, tc_fam in _mp_families(configs):
        _mp_family_report(key, fam, shape, tc_fam, rows, one_fam[key])

    # (d) the collectives
    for name, bound, vol in (
            ("ring", MP_RING_BOUND, costmodel.ring_allreduce_int8_volume(
                MP_COLL_N, P_DIST, dtype="float32")),
            ("psum", MP_PSUM_BOUND, costmodel.compressed_psum_volume(
                MP_COLL_N, P_DIST, method="bf16"))):
        got = [row["d"][name] for row in rows]
        walls = ", ".join(f"{1e3 * g['wall']:.1f}" for g in got)
        print(f"trainmp (d) {name}: {MP_COLL_N} float32 per rank, relative "
              f"error {max(g['rel'] for g in got):.3e} (bound {bound}), wall "
              f"{walls} ms by rank, wire bytes {got[0]['wire']} (cost model "
              f"{vol})")
        check(all(g["rel"] < bound for g in got),
              f"trainmp (d) {name}: error beyond {bound}")
        check(all(Fraction(g["wire"]) == vol for g in got),
              f"trainmp (d) {name}: wire bytes differ from the cost model")


def _mp_family_report(key, cfg, shape, tc, rows, one) -> None:
    """(f), (g), (h): every rank's losses against one process's ``one``,
    within MP_STEP1_TOL at step 1 and MP_LATER_TOL later, and each rank's
    blocks: the SSM's out-projection rows (its heads, where they split)
    and the attention's query columns (its heads)."""
    x0 = rows[0][key]
    m = shape[1]
    print(f"trainmp ({key}): {cfg.name} at {cfg.n_layers} layers on mesh "
          f"{shape}, {tc.steps} steps of {tc.global_batch} x {tc.seq_len}, "
          f"n_micro {cfg.n_micro}; one process: state "
          f"{one['state'] / 2**30:.3f} GiB, peak {one['peak'] / 2**30:.2f} "
          f"GiB, steps {', '.join(f'{w:.3f}' for w in one['steps'])} s")
    for i, want in enumerate(one["losses"]):
        rel = max(abs(r[key]["losses"][i] - want) / abs(want) for r in rows)
        tol = MP_STEP1_TOL if i == 0 else MP_LATER_TOL
        print(f"trainmp ({key}) step {i}: loss {x0['losses'][i]:.6f} vs one "
              f"process {want:.6f}: max relative {rel:.3e} (tolerance "
              f"{tol}); wall {max(r[key]['step_s'][i] for r in rows):.3f} s"
              f" (slowest rank)")
        check(rel <= tol, f"trainmp ({key}) step {i}: loss differs by "
              f"{rel:.3e}")
    # the blocks a rank holds: its "model" block of the heads' dimension
    # (the SSM's out-projection rows, the query columns) where it splits
    want_ssm = ((cfg.d_inner // m, cfg.d_model // shape[0])
                if cfg.ssm_state and cfg.ssm_nheads % m == 0 else None)
    want_wq = ((cfg.d_model // shape[0], cfg.n_heads * cfg.hd // m)
               if cfg.n_heads and cfg.n_heads % m == 0 else None)
    for r, row in enumerate(rows):
        x = row[key]
        print(f"  rank {r} {x['coords']}: ssm_out block {x['ssm_out']}, "
              f"attn_wq block {x['wq']}, state "
              f"{x['state_bytes'] / 2**30:.3f} GiB "
              f"({x['state_bytes'] / one['state']:.3f} of one process), "
              f"gloo host copies {x['copies']:.0f} and wire bytes "
              f"{float(Fraction(x['wire'])):.4e} per step, peak "
              f"{x['peak'] / 2**30:.2f} GiB")
        check(x["losses"] == x0["losses"], f"trainmp ({key}): ranks "
              "disagree")
        check(want_ssm is None or x["ssm_out"] == want_ssm,
              f"trainmp ({key}): ssm_out block {x['ssm_out']}")
        check(want_wq is None or x["wq"] == want_wq,
              f"trainmp ({key}): attn_wq block {x['wq']}")


def trainmp_cli() -> None:
    """``torchrun --nproc-per-node 1 -m repro_torch.launch.train --mesh
    host`` (the CLI joins a one-rank NCCL group and trains on its (1, 1)
    mesh) against ``--mesh none`` in this process: the same losses, and
    the checkpoint's manifest naming the mesh."""
    import re
    from repro_torch.launch import train as train_cli
    argv = ["--arch", "olmoe-1b-7b", "--smoke", "--steps", "3", "--seq-len",
            "256", "--batch", "4"]
    want = train_cli.main(argv + ["--mesh", "none"])
    ckpt_dir = MP_DIR / "cli"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "repro_torch.launch.train", *argv,
           "--mesh", "host", "--ckpt-dir", str(ckpt_dir)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    wall = time.perf_counter() - t0
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("done:")), "")
    print(f"trainmp torchrun CLI --mesh host (exit {proc.returncode}, "
          f"{wall:.1f} s with start-up): {line}")
    check(proc.returncode == 0,
          f"trainmp torchrun CLI failed:\n{proc.stderr[-3000:]}")
    m = re.search(r"loss ([\d.]+) -> ([\d.]+)", line)
    check(m is not None and (m[1], m[2]) == (f"{want.losses[0]:.4f}",
                                             f"{want.losses[-1]:.4f}"),
          f"trainmp torchrun CLI: losses differ from --mesh none's "
          f"{want.losses}")
    with open(ckpt_dir / "step_00000003" / "manifest.json") as f:
        shape = json.load(f)["mesh_shape"]
    print(f"trainmp torchrun CLI: --mesh none losses {want.losses}; the "
          f"checkpoint's mesh {shape}")
    check(shape == {"data": 1, "model": 1},
          f"trainmp torchrun CLI: checkpoint mesh {shape}")


def trainmp_phase(torch, dev, ops, want) -> None:
    """(a) at world size 1 through NCCL and the torchrun CLI, (b)-(h) on
    gloo ranks."""
    shutil.rmtree(MP_DIR, ignore_errors=True)
    MP_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    trainmp_world1(torch, dev, ops, want)
    trainmp_cli()
    torch.cuda.empty_cache()
    print(f"trainmp (a): part wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trainmp_ranks(torch, dev)
    print(f"trainmp (b)-(h): part wall {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(MP_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# the servemp phase: prefill and decode on a mesh of gloo ranks
# ---------------------------------------------------------------------------

def _smp_config(configs, arch: str, layers: int, dtype: str):
    cfg = configs.get(arch).with_(dtype=dtype)
    return cfg.with_(n_layers=layers) if layers else cfg


def _smp_runs():
    """(case, dtype) of every servemp run: each case in bfloat16, the
    SMP_F32 cases in float32 too, decoding SMP_F32_GEN tokens there."""
    runs = []
    for case in SMP_CASES:
        runs.append((case, "bfloat16"))
        if case[0] in SMP_F32:
            runs.append((case[:6] + (SMP_F32_GEN,) + case[7:], "float32"))
    return runs


def _smp_err(got, want) -> float:
    """max |got - want| over max |want| (exact equality for ``pos``)."""
    if not want.is_floating_point():
        return 0.0 if got.shape == want.shape and bool(
            (got == want).all()) else 1.0
    scale = float(want.float().abs().max()) or 1.0
    return float((got.float() - want.float()).abs().max()) / scale


def _smp_inputs(torch, cfg, b: int, prompt: int, dev):
    """The case's seeded prompts and (Whisper) frames."""
    return (lm_prompts(torch, cfg, b, prompt, seed=3, dev=dev),
            zoo_frames(torch, cfg, b, seed=4, dev=dev))


def _smp_cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for _, t in cache_leaves(cache))


def _smp_one(torch, dev, case, dtype: str) -> dict:
    """One process on the card in ``dtype``: prefill, then ``gen`` greedy
    decode steps; the logits, the cache after prefill (to the host), the
    tokens fed and returned, each step's top-2 margin, ms per decode
    step, peak, cache bytes."""
    from repro_torch import configs
    from repro_torch.models import lm, transformer
    tag, arch, layers, _, b, prompt, gen, max_len = case
    cfg = _smp_config(configs, arch, layers, dtype)
    model = transformer.init_params(cfg, seed=0, max_len=max_len,
                                    device=dev)
    pc = lm.cast_params(cfg, model)
    toks, frames = _smp_inputs(torch, cfg, b, prompt, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cache = transformer.init_cache(cfg, b, max_len, device=dev)
    args = [pc, cache, toks] + ([frames] if frames is not None else [])
    t0 = time.perf_counter()
    cache, logits = lm.make_prefill(cfg, max_len)(*args)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    snap = {"/".join(path): t.to("cpu", copy=True)
            for path, t in cache_leaves(cache)}
    decode = lm.make_decode_step(cfg)
    fed = [torch.argmax(logits, dim=-1).to(torch.int32)]
    # each step's top-2 margin over max |logit| (kept on the card): how
    # near a tie each greedy token is
    margins, greedy = [], lm._greedy

    def margin_greedy(step_logits):
        real = step_logits[..., :cfg.vocab]
        top = torch.topk(real, 2, dim=-1).values
        margins.append((top[..., 0] - top[..., 1])
                       / real.abs().amax(dim=-1))
        return greedy(step_logits)
    lm._greedy = margin_greedy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(gen):
            cache, nxt = decode(pc, cache, fed[-1], prompt + i)
            fed.append(nxt)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / gen
    finally:
        lm._greedy = greedy
    out = dict(logits=logits.cpu(), cache=snap,
               fed=torch.stack(fed).cpu(), prefill_s=prefill_s,
               margins=torch.stack(margins).float().cpu(),
               step_ms=step_ms, peak=torch.cuda.max_memory_allocated(),
               cache_bytes=_smp_cache_bytes(cache))
    del model, pc, cache
    torch.cuda.empty_cache()
    return out


def _smp_rank_case(torch, dev, ops, case, dtype: str, one, yard) -> dict:
    """One case on this rank of the mesh in ``dtype``: its blocks of the
    weights (cast to ``dtype`` once) and of the cache, its rows of the
    prompts and block of the frames; prefill, the gathered logits and
    cache against one process's (``one``; and against ``yard``, one
    process's float32 run, where given), ``gen`` decode steps fed one
    process's tokens; ms per step, wire bytes and host copies per step,
    peak, cache bytes."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm, transformer
    tag, arch, layers, shape, b, prompt, gen, max_len = case
    cfg = _smp_config(configs, arch, layers, dtype)
    mesh = make_mesh(shape, ("data", "model"), device=dev)
    specs = lm.param_shardings(cfg, mesh, max_len)
    model = transformer.init_params(cfg, seed=0, max_len=max_len,
                                    device=dev)
    lm.shard_params_(model, specs, mesh)
    pc = lm.cast_params(cfg, model)
    toks, frames = _smp_inputs(torch, cfg, b, prompt, dev)
    lay = lm.serve_shardings(cfg, mesh, b, max_len)
    kw = dict(mesh=mesh, specs=specs, batch=b)
    prefill = lm.make_prefill(cfg, max_len, **kw)
    decode = lm.make_decode_step(cfg, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    cache = lm.init_cache_blocks(cfg, mesh, b, max_len, device=dev)
    args = [pc, cache, mesh.shard(toks, lay["tokens"])]
    if frames is not None:
        args.append(mesh.shard(frames, lay["frames"]))
    mesh.barrier()
    t0 = time.perf_counter()
    cache, logits = prefill(*args)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    logits = mesh.gather(logits, lay["logits"]).cpu()
    whole = lm.gather_tree(cache, lay["cache"], mesh)
    errs, yard_errs = {}, {}
    for path, t in cache_leaves(whole):
        key = "/".join(path)
        errs[key] = _smp_err(t.cpu(), one["cache"][key])
        if yard is not None:
            yard_errs[key] = _smp_err(t.cpu(), yard["cache"][key])
    del whole
    fed = one["fed"].to(dev)
    rows = [mesh.shard(fed[i], lay["token"]) for i in range(gen)]
    mesh.barrier()
    copies0 = mesh.host_copies
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    def steps():
        nonlocal cache
        outs = []
        for i in range(gen):
            cache, nxt = decode(pc, cache, rows[i], prompt + i)
            outs.append(nxt)
        return outs
    outs, wire = _mp_watch(steps)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / gen
    got = torch.stack([mesh.gather(o, lay["token"]) for o in outs]).cpu()
    flipped = got != one["fed"][1:]
    real = flipped & (one["margins"] > SMP_TIE)
    out = dict(
        tag=tag, coords=mesh.coords,
        logit_err=_smp_err(logits[:, :cfg.vocab],
                           one["logits"][:, :cfg.vocab]),
        yard_logit_err=(None if yard is None else _smp_err(
            logits[:, :cfg.vocab], yard["logits"][:, :cfg.vocab])),
        cache_err=errs, yard_cache_err=yard_errs,
        flips=int(flipped.sum(dim=0).max()),
        real_flips=int(real.sum(dim=0).max()),
        flip_margin=float(one["margins"][flipped].max()) if bool(
            flipped.any()) else 0.0,
        min_margin=float(one["margins"].min()),
        prefill_s=prefill_s, step_ms=step_ms,
        wire=str(wire / gen), copies=(mesh.host_copies - copies0) / gen,
        peak=torch.cuda.max_memory_allocated(),
        cache_bytes=_smp_cache_bytes(cache),
        launched=dict(ops.LAUNCHES))
    del model, pc, cache
    torch.cuda.empty_cache()
    return out


def _servemp_rank(rank, cfg, out_q):
    """One of ``cfg["world"]`` gloo ranks sharing ``cfg["device"]``: every
    case of SMP_CASES against one process's results under SMP_DIR."""
    import datetime
    import traceback
    sys.path.insert(0, str(SRC))
    import torch
    from repro_torch.comm import group
    from repro_torch.kernels import ops
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = group.init_process_group(
            cfg["device"], backend="gloo", world_size=cfg["world"],
            rank=rank, init_method=f"file://{cfg['init_file']}",
            timeout=datetime.timedelta(seconds=600))
        out = {}
        for case, dtype in _smp_runs():
            one = torch.load(SMP_DIR / f"one_{case[0]}_{dtype}.pt")
            yard = None
            if dtype != "float32" and case[0] in SMP_F32:
                yard = torch.load(SMP_DIR / f"one_{case[0]}_float32.pt")
            out[case[0], dtype] = _smp_rank_case(torch, dev, ops, case,
                                                 dtype, one, yard)
            del one, yard
        out_q.put((rank, True, out))
    except BaseException:
        out_q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        group.destroy_process_group()


def servemp_phase(torch, dev) -> None:
    """(a)-(e) of SMP_CASES: one process on the card first (its results
    under SMP_DIR), then P_DIST gloo ranks sharing the card in one spawn,
    each case held against one process."""
    shutil.rmtree(SMP_DIR, ignore_errors=True)
    SMP_DIR.mkdir(parents=True)
    ones = {}
    t0 = time.perf_counter()
    for case, dtype in _smp_runs():
        one = _smp_one(torch, dev, case, dtype)
        torch.save(one, SMP_DIR / f"one_{case[0]}_{dtype}.pt")
        ones[case[0], dtype] = {k: one[k] for k in (
            "prefill_s", "step_ms", "peak", "cache_bytes", "logits",
            "cache")}
        del one
    print(f"servemp: one process, every case, in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = dict(device=str(dev), world=P_DIST, init_file=str(SMP_DIR / "pg"))
    t0 = time.perf_counter()
    results = spawn_ranks(_servemp_rank, cfg, "servemp")
    print(f"servemp: {P_DIST} gloo ranks on one card, (a)-(e) in "
          f"{time.perf_counter() - t0:.1f} s (process start included)")
    for case, dtype in _smp_runs():
        tag, arch, layers, shape, b, prompt, gen, max_len = case
        one = ones[tag, dtype]
        rows = [results[r][tag, dtype] for r in range(P_DIST)]
        tol, leaf_tol = SMP_TOL, {}
        if dtype == "float32":
            tol = ZOO_F32_TOL
        yard = ones.get((tag, "float32")) if dtype != "float32" else None
        if yard is not None:
            # one process's own bf16 error against its f32 run, the
            # yardstick of the mesh's bf16 run (against the same f32 run)
            own = _smp_err(one["logits"], yard["logits"])
            leaf_tol = {k: SMP_BF16_SPREAD * _smp_err(v, yard["cache"][k])
                        for k, v in one["cache"].items()}
            print(f"servemp ({tag}) {dtype}: one process against its f32 "
                  f"run: logits {own:.3e} of max |logit|, cache worst "
                  f"{max(leaf_tol.values()) / SMP_BF16_SPREAD:.3e}")
        print(f"servemp ({tag}) {dtype}: {arch}"
              f"{f' at {layers} layers' if layers else ''} on mesh {shape}, "
              f"{b} x {prompt} + {gen} greedy tokens (max_len {max_len}); "
              f"one process: prefill {one['prefill_s']:.3f} s, "
              f"{one['step_ms']:.2f} ms per decode step, peak "
              f"{one['peak'] / 2**30:.2f} GiB, cache "
              f"{one['cache_bytes'] / 2**30:.4f} GiB")
        for r, x in enumerate(rows):
            worst = max(x["cache_err"].items(), key=lambda kv: kv[1])
            yard_line = ""
            if yard is not None:
                yworst = max(x["yard_cache_err"].items(),
                             key=lambda kv: kv[1] / max(leaf_tol[kv[0]],
                                                        1e-30))
                yard_line = (f" against one process's f32 run: logits "
                             f"{x['yard_logit_err']:.3e} (allowed "
                             f"{SMP_BF16_SPREAD * own:.3e}), cache "
                             f"{yworst[0]} {yworst[1]:.3e} (allowed "
                             f"{leaf_tol[yworst[0]]:.3e});")
            print(f"  rank {r} {x['coords']}: prefill {x['prefill_s']:.3f} "
                  f"s, logits within {x['logit_err']:.3e} of max |logit|; "
                  f"cache worst {worst[0]} {worst[1]:.3e} of its max "
                  f"({f'tolerance {tol}' if yard is None else 'held below'}"
                  f");"
                  f"{yard_line} at most {x['flips']} of "
                  f"{gen} greedy tokens of a sequence differ, one "
                  f"process's top-2 margin there at most "
                  f"{x['flip_margin']:.2e} of max |logit| (its least "
                  f"{x['min_margin']:.2e}), {x['real_flips']} beyond a "
                  f"margin of {SMP_TIE:.2e} (allowed {SMP_FLIPS}); "
                  f"{x['step_ms']:.2f} ms per decode step; wire bytes "
                  f"{float(Fraction(x['wire'])):.4e} and gloo host copies "
                  f"{x['copies']:.0f} per step; peak "
                  f"{x['peak'] / 2**30:.2f} GiB; cache "
                  f"{x['cache_bytes'] / 2**30:.4f} GiB "
                  f"({x['cache_bytes'] / one['cache_bytes']:.3f} of one "
                  f"process); kernel-4 launches "
                  f"{x['launched']['flash_attention']}")
            what = f"servemp ({tag}) {dtype} rank {r}"
            if yard is None:
                check(x["logit_err"] <= tol, f"{what}: logits differ by "
                      f"{x['logit_err']:.3e}")
                check(worst[1] <= tol, f"{what}: cache {worst[0]} differs "
                      f"by {worst[1]:.3e}")
            else:
                check(x["yard_logit_err"] <= SMP_BF16_SPREAD * own,
                      f"{what}: logits {x['yard_logit_err']:.3e} from the "
                      f"f32 run")
                check(all(e <= leaf_tol[k]
                          for k, e in x["yard_cache_err"].items()),
                      f"{what}: cache {yworst[0]} {yworst[1]:.3e} from the "
                      f"f32 run")
            check(x["real_flips"] <= SMP_FLIPS,
                  f"{what}: {x['real_flips']} greedy tokens beyond a "
                  f"near-tie differ")
            check(not any(x["launched"].values()),
                  f"{what}: a kernel launched: {x['launched']}")
    shutil.rmtree(SMP_DIR, ignore_errors=True)


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


def main_cell_config(est_mod, **kw):
    """The main cell's solver: Cov, f64, kernels 1 and 2."""
    return est_mod.SolverConfig(backend="reference", variant="cov",
                                use_pallas=True, sparse_matmul="on",
                                dtype="float64", **kw)


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
    est = est_mod.ConcordEstimator(penalty=penalty.PenaltySpec.l1(0.3, 0.05),
                                   config=main_cell_config(est_mod))
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
    check_prox_launches(launches_fit, rep.ls_total, "main fit")
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
    check_prox_launches(launches, rep.ls_total + path.total_ls,
                        "main fit and path")
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
    fused prox's weighted trial entry)."""
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
            check(weighted[TRIAL_KEY] == t2 > 0,
                  "weighted fused-prox trial launches != stage-2 trials")
            check_prox_launches(launches, path.stage1.total_ls + t2,
                                "adaptive sequential, both stages")
            out[TRIAL_KEY + "[weighted]"] = t2
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
    check_prox_launches(ops.LAUNCHES, rep.ls_total, "obs fit")
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
        check_prox_launches(l_fit, rep.ls_total, "fit_gram")
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
            check(b.ls_total > 0 and lb["blocksparse_matmul"] > 0,
                  f"dist {variant}: kernel 2 never ran")
            # kernel 1 per trial: the trial entry on the reference
            # backend, the stats entry on the distributed one
            check_prox_launches(la, a.ls_total, f"dist {variant} reference")
            check_prox_launches(lb, b.ls_total, f"dist {variant}",
                                trial=False)
            check({**la, TRIAL_KEY: 0, "fused_prox_stats": 0}
                  == {**lb, TRIAL_KEY: 0, "fused_prox_stats": 0},
                  f"dist {variant}: launches {lb} differ from the reference "
                  f"backend's {la}")
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


def dist_problem(torch, graphs, dev, p: int = DIST_P, n: int = DIST_N):
    """The (b) problem, drawn alike on every rank: X (n, p) of the chain
    graph and its S, on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(5)
    x = graphs.sample_gaussian_torch(
        graphs.chain_omega(p, dtype=np.float64), n, gen, dev)
    return x, (x.T @ x) / n


def spawn_ranks(target, cfg: dict, what: str) -> dict:
    """``target(rank, cfg, out_q)`` in ``cfg["world"]`` spawned processes
    sharing the card; their results by rank.  A rank that fails, or
    none that answers within 600 s, fails the phase; every process is
    joined (or terminated) before this returns."""
    import multiprocessing as mp
    import queue
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, cfg, out_q))
             for r in range(cfg["world"])]
    for pr in procs:
        pr.start()
    results = {}
    try:
        while len(results) < len(procs):
            try:
                rank, ok, val = out_q.get(timeout=600)
            except queue.Empty:
                fail(f"{what} ranks: no result within 600 s")
            check(ok, f"{what} rank {rank} failed:\n{val}")
            results[rank] = val
    finally:
        for pr in procs:
            pr.join(timeout=60)
            if pr.is_alive():
                pr.terminate()
                pr.join(timeout=30)
    check(all(pr.exitcode == 0 for pr in procs),
          f"{what} ranks exit codes {[pr.exitcode for pr in procs]}")
    return results


def dist_ranks(torch, mods, dev) -> None:
    """(b) P_DIST processes on the one card over gloo: each grid's solve
    against the single-device solve on the card."""
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
    t0 = time.perf_counter()
    results = spawn_ranks(_dist_rank, cfg, "dist")
    wall = time.perf_counter() - t0
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
            check_prox_launches(row["launches"], row["trials"],
                                f"dist {variant} ({cx},{co})", trial=False)
            check(row["launches"]["blocksparse_matmul"] > 0,
                  f"dist {variant} ({cx},{co}): kernel 2 never ran")
            check(row["bytes"] == row["volume"],
                  f"dist {variant} ({cx},{co}): wire bytes != comm_volume")


def dist_kernel_times(torch, ops, ref, dev) -> None:
    """Kernels 1 and 2 at the shapes this slice gives them, timed alone on
    the card: kernel 1 on a rank's panel with its off-origin diagonal
    mask (world size 1: the whole 16384^2 matrix; P = 4: a (DIST_P,
    DIST_P / 4) Cov panel), kernel 2 on a ring round's tile (DIST_P / 4,
    DIST_P) @ (DIST_P, DIST_P / 4) at ~3% occupied blocks."""
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


def span_tree(spans) -> list[str]:
    """One line per span or event, indented by nesting (containment)."""
    lines, stack = [], []
    for s in sorted(spans, key=lambda s: (s.t_start, -s.duration)):
        while stack and s.t_start >= stack[-1].t_start + stack[-1].duration:
            stack.pop()
        args = " ".join(f"{k}={v}" for k, v in sorted(s.args.items()))
        lines.append(f"  {'  ' * len(stack)}{s.name} {1e3 * s.duration:.3f}"
                     f" ms {args}")
        if s.phase == "span":
            stack.append(s)
    return lines


def telemetry_levels(torch, mods, state) -> None:
    """The main cell's ``fit_cov`` at obs off / summary / trace, warm, in
    the order off, summary, trace, trace, summary, off: the estimate bit
    for bit, the counts and kernel launches equal at every level; walls
    and overheads; the span tree and the solve counters."""
    from repro_torch.obs import metrics, trace
    _, est_mod, penalty, ops = mods
    s = state["s"]
    tracer, reg = trace.get_tracer(), metrics.get_registry()

    def fit(level):
        est = est_mod.ConcordEstimator(
            penalty=penalty.PenaltySpec.l1(0.3, 0.05),
            config=main_cell_config(est_mod, obs=level))
        ops.reset_launches()
        t0 = time.perf_counter()
        rep = est.fit_cov(s, n_samples=N_MAIN).report_
        return rep, time.perf_counter() - t0, dict(ops.LAUNCHES)

    base, _, base_launches = fit("off")         # warm-up and the baseline
    tracer.clear()
    reg.clear()
    walls = {"off": [], "summary": [], "trace": []}
    tele = None
    for level in ("off", "summary", "trace", "trace", "summary", "off"):
        rep, wall, launches = fit(level)
        err = float((rep.omega - base.omega).abs().max())
        walls[level].append(wall)
        print(f"telemetry obs={level}: iters={rep.iters} trials="
              f"{rep.ls_total} wall {wall:.4f} s (solve {rep.wall_time_s:.4f}"
              f" s) max |dOmega| {err} launches {launches}")
        check(err == 0.0, f"obs={level}: the estimate moved ({err})")
        check((rep.iters, rep.ls_total, rep.converged) == (
            base.iters, base.ls_total, base.converged),
            f"obs={level}: counts differ from obs=off")
        check(launches == base_launches,
              f"obs={level}: kernel launches {launches} != {base_launches}")
        check((rep.telemetry is None) == (level == "off"),
              f"obs={level}: telemetry presence")
        if level == "trace":
            tele = rep.telemetry
        del rep
    mean = {k: sum(v) / len(v) for k, v in walls.items()}
    for level in ("summary", "trace"):
        print(f"telemetry overhead obs={level} over off: "
              f"{mean[level] - mean['off']:+.4f} s "
              f"({100 * (mean[level] / mean['off'] - 1):+.2f}%; means of 2:"
              f" {mean[level]:.4f} vs {mean['off']:.4f} s)")
    print(f"telemetry (trace): dispatch {tele['dispatch_s']:.4f} s, execute "
          f"{1e3 * tele['execute_s']:.3f} ms, {tele['ls_per_iter']:.3f} "
          f"trials/iter, flops {tele['flops']:.4e}, words "
          f"{tele['words']:.4e}")
    print("span tree (2 summary + 2 trace fits):")
    for line in span_tree(tracer.snapshot()):
        print(line)
    snap = reg.snapshot()
    for key, val in snap.items():
        if key.startswith("repro_solve"):
            print(f"  {key} = {val}")
    check(snap['repro_solves_total{variant="cov"}'] == 4,
          "the solve counter did not count the 4 observed fits")
    check([s.name for s in tracer.snapshot()].count("dispatch") == 2,
          "trace-level spans missing or recorded at summary")


def telemetry_path(torch, mods, state) -> None:
    """A 3-point ``fit_path`` under trace, exported as a Chrome trace and
    read back by ``python -m repro_torch.obs.cli print`` and ``export``."""
    from repro_torch.obs import trace
    _, est_mod, penalty, ops = mods
    tracer = trace.get_tracer()
    tracer.clear()
    est = est_mod.ConcordEstimator(
        penalty=penalty.PenaltySpec.l1(0.3, 0.05),
        config=main_cell_config(est_mod, obs="trace"))
    ops.reset_launches()
    t0 = time.perf_counter()
    path = est.fit_path(s=state["s"], lam1_grid=LAM_PATH, n_samples=N_MAIN)
    wall = time.perf_counter() - t0
    spans = tracer.snapshot()
    names = [s.name for s in spans]
    print(f"traced fit_path: {len(path)} points, iters={path.total_iters} "
          f"trials={path.total_ls} wall {wall:.3f} s, {len(spans)} spans, "
          f"launches {dict(ops.LAUNCHES)}")
    check([names.count(k) for k in ("fit_path", "fit.reference", "dispatch",
                                    "execute")] == [1, 3, 3, 3],
          f"traced path spans {names}")
    check_prox_launches(ops.LAUNCHES, path.total_ls, "traced path")
    chrome, jsonl = TELE_DIR / "path.json", TELE_DIR / "path.jsonl"
    check(tracer.export_chrome(chrome) == len(spans), "chrome export")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for argv in (["print", str(chrome)], ["export", str(chrome),
                                          str(jsonl)]):
        proc = subprocess.run([sys.executable, "-m", "repro_torch.obs.cli",
                               *argv], env=env, capture_output=True,
                              text=True, timeout=300, cwd=ROOT)
        check(proc.returncode == 0 and (argv[0] == "export"
                                        or "fit_path" in proc.stdout),
              f"obs.cli {argv[0]} failed:\n{proc.stderr[-3000:]}")
        print(f"obs.cli {argv[0]}: " + " | ".join(
            proc.stdout.strip().splitlines()[-4:]))
    check(len(trace.load_jsonl(jsonl)) == len(spans), "export round trip")
    tracer.clear()


def _recon_rows(tele) -> list[str]:
    return [f"    {r['prim']:<10} {','.join(r['axes']):<6} "
            f"{r['measured_count']:>5}x {r['measured_bytes']:>14} B | "
            f"predicted {r['predicted_count']:>5}x "
            f"{r['predicted_bytes']:>14} B "
            f"{'OK' if r['match'] else 'MISMATCH'}"
            for rep in tele["comm_reconcile"] for r in rep["rows"]]


def telemetry_dist(torch, mods, dev) -> None:
    """The dense distributed solve at world size 1 through NCCL at
    ``obs="trace"``: Cov on the main S, Obs on its X (n = 8192); every
    (prim, axes) row of the comm reconciliation must match."""
    from repro_torch.comm import group
    graphs, est_mod, penalty, ops = mods
    gen = torch.Generator(device=dev).manual_seed(0)
    x = graphs.sample_gaussian_torch(
        graphs.chain_omega(P_MAIN, dtype=np.float64), N_MAIN, gen, dev)
    s = (x.T @ x) / N_MAIN
    group.init_process_group(dev, world_size=1, rank=0,
                             init_method=f"tcp://localhost:{free_port()}")
    try:
        for variant in ("cov", "obs"):
            est = est_mod.ConcordEstimator(
                penalty=penalty.PenaltySpec.l1(0.3, 0.05),
                config=est_mod.SolverConfig(
                    backend="distributed", variant=variant, use_pallas=True,
                    dtype="float64", obs="trace"))
            ops.reset_launches()
            t0 = time.perf_counter()
            rep = (est.fit_cov(s, n_samples=N_MAIN) if variant == "cov"
                   else est.fit(x)).report_
            wall = time.perf_counter() - t0
            tele = rep.telemetry
            print(f"dense distributed {variant} at world size 1 (NCCL), obs "
                  f"trace: iters={rep.iters} trials={rep.ls_total} wall "
                  f"{wall:.3f} s launches {dict(ops.LAUNCHES)}; "
                  f"comm_reconcile_ok={tele['comm_reconcile_ok']}")
            for line in _recon_rows(tele):
                print(line)
            check(tele["comm_reconcile_ok"] is True
                  and len(tele["comm_reconcile"]) == 1,
                  f"dense {variant}: the reconciliation failed")
            check(rep.converged and not rep.stalled,
                  f"dense {variant}: no convergence")
            check_prox_launches(ops.LAUNCHES, rep.ls_total,
                                f"dense {variant}", trial=False)
            del rep
    finally:
        group.destroy_process_group()
    del x, s
    torch.cuda.empty_cache()


def _telemetry_rank(rank, cfg, out_q):
    """One of ``cfg["world"]`` gloo ranks sharing the card: the dense
    distributed fit of each of ``cfg["grids"]`` through the facade at
    ``obs="trace"``, and this rank's comm reconciliation."""
    import datetime
    import traceback
    sys.path.insert(0, str(SRC))
    import torch
    from repro_torch import estimator as est_mod
    from repro_torch.comm import group
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = group.init_process_group(
            cfg["device"], backend="gloo", world_size=cfg["world"],
            rank=rank, init_method=f"file://{cfg['init_file']}",
            timeout=datetime.timedelta(seconds=300))
        data = torch.load(cfg["data"], map_location=dev)
        out = []
        for variant, cx, co in cfg["grids"]:
            est = est_mod.ConcordEstimator(lam1=0.3, lam2=0.05, config=(
                est_mod.SolverConfig(
                    backend="distributed", variant=variant, c_x=cx,
                    c_omega=co, use_pallas=True, dtype="float64",
                    obs="trace", device=str(dev))))
            t0 = time.perf_counter()
            rep = (est.fit_cov(data["s"], n_samples=cfg["n"])
                   if variant == "cov" else est.fit(data["x"])).report_
            out.append(dict(variant=variant, grid=(cx, co), iters=rep.iters,
                            trials=rep.ls_total,
                            wall=time.perf_counter() - t0,
                            telemetry=rep.telemetry))
        out_q.put((rank, True, out))
    except BaseException:
        out_q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        group.destroy_process_group()


def telemetry_ranks(torch, mods, dev) -> None:
    """P_DIST gloo ranks sharing the card at TELE_P: every rank's
    reconciliation of each TELE_GRIDS solve holds."""
    graphs = mods[0]
    x, s = dist_problem(torch, graphs, dev, TELE_P, TELE_N)
    cfg = dict(device=str(dev), world=P_DIST, grids=TELE_GRIDS, n=TELE_N,
               init_file=str(TELE_DIR / "pg"), data=str(TELE_DIR / "xs.pt"))
    torch.save({"x": x, "s": s}, cfg["data"])
    del x, s
    t0 = time.perf_counter()
    results = spawn_ranks(_telemetry_rank, cfg, "telemetry")
    print(f"telemetry P={P_DIST}: {len(TELE_GRIDS)} dense solves at p="
          f"{TELE_P} in {time.perf_counter() - t0:.1f} s (process start "
          f"included)")
    for i, (variant, cx, co) in enumerate(TELE_GRIDS):
        rows = [results[r][i] for r in range(P_DIST)]
        for r, row in enumerate(rows):
            tele = row["telemetry"]
            rec = tele["comm_reconcile"][0]
            print(f"  {variant} (4,{cx},{co}) rank {r}: iters={row['iters']} "
                  f"trials={row['trials']} wall {row['wall']:.2f} s; "
                  f"measured {rec['measured_bytes_total']} B = predicted "
                  f"{rec['predicted_bytes_total']} B: "
                  f"{tele['comm_reconcile_ok']}")
            if r == 0:
                for line in _recon_rows(tele):
                    print(line)
            check(tele["comm_reconcile_ok"] is True,
                  f"telemetry {variant} ({cx},{co}) rank {r}: the "
                  f"reconciliation failed")
            check(Fraction(rec["measured_bytes_total"]) > 0,
                  f"telemetry {variant} ({cx},{co}) rank {r}: no bytes moved")
        check(len({(row["iters"], row["trials"]) for row in rows}) == 1,
              f"telemetry {variant} ({cx},{co}): ranks disagree on counts")


def telemetry_cli() -> None:
    """``torchrun --nproc-per-node 1 -m repro_torch.obs.cli reconcile`` at
    the CLI's default problem (torchrun's own parser refuses ``--n`` as an
    ambiguous abbreviation of its options, even after the module)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "repro_torch.obs.cli", "reconcile",
           "--max-iters", "50", "--json-out", str(TELE_DIR / "reconcile.json")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    wall = time.perf_counter() - t0
    out = proc.stdout.strip().splitlines()
    print(f"torchrun obs.cli reconcile (exit {proc.returncode}, {wall:.1f} s "
          f"with start-up): " + " | ".join(
              ln for ln in out if "->" in ln or ln.startswith("OK")))
    check(proc.returncode == 0 and out and out[-1].startswith("OK"),
          f"obs.cli reconcile failed:\n{proc.stdout[-2000:]}\n"
          f"{proc.stderr[-2000:]}")


def telemetry_phase(torch, mods, dev, state) -> None:
    shutil.rmtree(TELE_DIR, ignore_errors=True)
    TELE_DIR.mkdir(parents=True)
    try:
        telemetry_levels(torch, mods, state)
        telemetry_path(torch, mods, state)
        torch.cuda.empty_cache()
        telemetry_dist(torch, mods, dev)
        telemetry_ranks(torch, mods, dev)
        telemetry_cli()
    finally:
        shutil.rmtree(TELE_DIR, ignore_errors=True)


def serve_phase(torch, dev) -> None:
    """``launch.serve --workload concord`` on the card: SERVE_REQUESTS
    requests in groups of SERVE_BATCH at (SERVE_N, SERVE_P), obs summary."""
    from repro_torch.launch import serve
    from repro_torch.obs import metrics
    reg = metrics.get_registry()
    reg.clear()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = serve.main(SERVE_ARGV)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    lat = st.latency_s
    n_conv = sum(r.converged for r in st.reports)
    iters = [r.iters for r in st.reports]
    print(f"serve: {SERVE_REQUESTS} requests at (n {SERVE_N}, p {SERVE_P}) "
          f"f32 in {st.n_groups} groups {st.group_shapes[0]}: batched "
          f"{st.t_batched:.3f} s = {SERVE_REQUESTS / st.t_batched:.3f} req/s, "
          f"sequential {st.t_sequential:.3f} s = "
          f"{SERVE_REQUESTS / st.t_sequential:.3f} req/s; latency p50 "
          f"{np.quantile(lat, 0.5):.3f} s p99 {np.quantile(lat, 0.99):.3f} s;"
          f" iters {min(iters)}-{max(iters)} (sum {sum(iters)}), converged "
          f"{n_conv}/{SERVE_REQUESTS}; max_gap {st.max_gap:.3e}; peak "
          f"{peak / 2**30:.2f} GiB above the {base / 2**30:.1f} GiB held "
          f"before; whole call {wall:.1f} s (host draws of the requests "
          f"included)")
    check(len(st.reports) == SERVE_REQUESTS and all(
        r.lam1 == float(lam) and r.device.startswith("cuda")
        for r, lam in zip(st.reports, st.lam1s)),
        "serve: reports missing, out of order or not on the card")
    check(st.n_groups == SERVE_REQUESTS // SERVE_BATCH and st.group_shapes
          == [(SERVE_BATCH, SERVE_N, SERVE_P)] * st.n_groups,
          f"serve: groups {st.group_shapes}")
    check(st.max_gap < 5e-3, f"serve: max_gap {st.max_gap} >= 5e-3")
    check(all(bool(torch.isfinite(r.omega).all()) for r in st.reports),
          "serve: a non-finite estimate")
    snap = reg.snapshot()
    for name in ("latency", "queue_wait", "solve_wall"):
        check(snap[f"repro_serve_{name}_seconds"]["count"] == SERVE_REQUESTS,
              f"serve: the {name} histogram did not count every request")
    reg.clear()
    return st


def profile_serve(torch, mods, dev, st) -> None:
    """Device time by kernel over one serve group (``fit_batch`` of
    SERVE_BATCH requests at the drain's first group's lam1s) and over the
    same requests solved one by one, on requests drawn on the card at the
    serve shape with the drain's knobs."""
    graphs, est_mod, _, _ = mods
    lam = [float(st.lam1s[i]) for i in st.order[:SERVE_BATCH]]
    gen = torch.Generator(device=dev).manual_seed(3)
    om = graphs.chain_omega(SERVE_P, dtype=np.float64)
    xs = torch.stack([graphs.sample_gaussian_torch(om, SERVE_N, gen, dev)
                      for _ in lam]).float()
    cfg = est_mod.SolverConfig(backend="reference", variant="obs",
                               tol=1e-5, max_iters=300)

    def batched():
        return est_mod.fit_batch(x=xs, lam1=lam, lam2=0.05, config=cfg)

    def sequential():
        return [est_mod.ConcordEstimator(lam1=lv, lam2=0.05, config=cfg)
                .fit(xs[i]).report_ for i, lv in enumerate(lam)]

    for name, fn in (("batched group", batched),
                     ("the same requests one by one", sequential)):
        fn()                                               # warm
        out, wall, busy, rows = _profile(torch, fn)
        reps = out.reports if name == "batched group" else out
        trials = sum(r.ls_total for r in reps)
        extra = (f"; {out.stats.summary()}" if name == "batched group"
                 else "")
        print(f"profile: serve {name} ({len(lam)} x ({SERVE_N}, {SERVE_P})"
              f" f32) wall={wall:.3f} s (profiled), {trials} lane trials "
              f"({1e3 * wall / trials:.3f} ms each), device busy "
              f"{busy:.3f} s, idle share {1.0 - busy / wall:.3f}{extra}")
        for secs, n, key in rows[:10]:
            print(f"  {100 * secs / wall:5.1f}% {1e3 * secs / trials:7.3f} "
                  f"ms/lane trial x{n:<6d} {key[:90]}")


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
# phases 12b-12c: the crossover's calibration and the Section 5 pipeline
# ---------------------------------------------------------------------------

def calibrate_phase(torch, mods, ref, dev) -> None:
    """Kernel 2 against the dense product at p = P_MAIN, block BLOCK, for
    m in CAL_MS over CAL_DENSITIES (block masks drawn from a seeded
    generator, built by ``matops.block_mask`` as the dispatch builds
    them), CUDA-event times; the rows refit ``BlockSparseModel``
    (``calibrate_block_model``) and both models' crossovers are printed
    beside the committed ``CARD_BLOCK_MODEL``."""
    from repro_torch.core import costmodel as cm
    from repro_torch.core import matops
    from repro_torch.kernels import manifest as kman
    ops = mods[3]
    p, bs = P_MAIN, BLOCK
    nb = p // bs
    gen = torch.Generator(device=dev).manual_seed(11)
    a_full = torch.randn((p, p), generator=gen, dtype=torch.float64,
                         device=dev)
    tol = kman.entry("blocksparse_matmul")["rtol"]["float64"]
    rows = []
    for m in CAL_MS:
        b = torch.randn((p, m), generator=gen, dtype=torch.float64,
                        device=dev)
        reps = 5 if m >= 4096 else 20
        for d in CAL_DENSITIES:
            occ = max(1, round(d * nb * nb))
            keep = torch.zeros(nb * nb, dtype=torch.bool, device=dev)
            keep[torch.randperm(nb * nb, generator=gen, device=dev)[:occ]] \
                = True
            keep = keep.reshape(nb, nb)
            a = a_full * keep.repeat_interleave(bs, 0) \
                .repeat_interleave(bs, 1)
            mask = matops.block_mask(a, bs)
            check(torch.equal(mask > 0, keep), "block_mask != drawn mask")
            ops.reset_launches()
            t_sparse = time_ms(torch, lambda: matops.masked_matmul(
                a, b, mask, block_size=bs, capacity=occ), reps, 1)
            check(ops.LAUNCHES["blocksparse_matmul"] == reps + 1,
                  "calibrate: the sparse branch did not launch kernel 2")
            t_dense = time_ms(torch, lambda: a @ b, reps, 1)
            row = {"p": p, "m": m, "block_size": bs, "density": occ / nb**2,
                   "occupied": occ, "t_dense": 1e-3 * t_dense,
                   "t_sparse": 1e-3 * t_sparse}
            if (m, d) in CAL_PLAIN:
                got = matops.masked_matmul(a, b, mask, block_size=bs,
                                           capacity=occ)
                want = ref.masked_matmul(a, b, mask, block_size=bs,
                                         capacity=occ)
                err = float((got - want).abs().max())
                check(torch.allclose(got, want, rtol=tol, atol=tol),
                      f"calibrate: kernel 2 disagrees with its plain "
                      f"version at m={m}, density {d}: {err:.3e}")
                row["max_abs_err"] = err
                del got, want
                torch.cuda.empty_cache()
            rows.append(row)
            print(f"calibrate: m={m:5d} density {row['density']:.4f} "
                  f"({occ:5d} blocks): dense {t_dense:9.3f} ms, kernel 2 "
                  f"{t_sparse:9.3f} ms"
                  + (f", vs plain max abs err {row['max_abs_err']:.3e}"
                     if "max_abs_err" in row else ""))
            del a, mask
        del b
    del a_full
    torch.cuda.empty_cache()
    fit = cm.calibrate_block_model(rows)
    print(f"calibrate: fitted BlockSparseModel(dense_eff={fit.dense_eff!r}, "
          f"sparse_eff={fit.sparse_eff!r}, gather_eff={fit.gather_eff!r}) "
          f"over the H100 data sheet; committed CARD_BLOCK_MODEL "
          f"{cm.CARD_BLOCK_MODEL}")
    for r in rows:
        pred = cm.blocksparse_matmul_time(r["p"], r["m"], r["density"], bs,
                                          model=fit)
        print(f"calibrate: residual m={r['m']:5d} density "
              f"{r['density']:.4f}: kernel 2 {1e3 * r['t_sparse']:.3f} ms, "
              f"fit {1e3 * pred:.3f} ms ({pred / r['t_sparse'] - 1:+.1%}); "
              f"dense {1e3 * r['t_dense']:.3f} ms, fit "
              f"{1e3 * cm.dense_matmul_time(r['p'], r['m'], model=fit):.3f}"
              f" ms")
    for m in CAL_MS:
        print(f"calibrate: crossover at p={p} m={m} block {bs}: data sheet "
              f"{cm.crossover_density(p, m, bs):.4f}, this fit "
              f"{cm.crossover_density(p, m, bs, model=fit):.4f}, "
              f"CARD_BLOCK_MODEL "
              f"{cm.crossover_density(p, m, bs, model=cm.CARD_BLOCK_MODEL):.4f}")
    print("calibrate rows: " + json.dumps(rows))


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def support_agreement(clustering, om_a, om_b, tol: float) -> str:
    """Edges in one support and not the other, vertices whose degree
    differs, and max |dOmega| between two estimates on the card."""
    sa = clustering.estimate_support(om_a, tol)
    sb = clustering.estimate_support(om_b, tol)
    diff_edges = int((sa ^ sb).sum()) // 2
    edges = int(sa.sum()) // 2
    deg_diff = int((clustering.degrees_from_support(sa)
                    != clustering.degrees_from_support(sb)).sum())
    d_om = float((om_a - om_b).abs().max())
    return (f"{edges} edges, {diff_edges} in one support only, {deg_diff} "
            f"vertices of another degree, max |dOmega| {d_om:.3e}")


def brain_phase(torch, mods, dev) -> None:
    """The Section 5 pipeline (``examples/torch_brain_clustering.py``) at
    a BRAIN_SIDE^2 cortex of BRAIN_REGION^2 regions, n = BRAIN_N frames
    drawn on the card: the full (lam1, lam2) grid through kernels 1 and 2
    with ``sparse_matmul="auto"`` (the card's calibrated threshold), the
    host clustering, the baseline and the example's assertion; then the
    chosen point cold, through the kernels and at the reference example's
    own config (dense, no kernel)."""
    from repro_torch.core import clustering
    from repro_torch.core.costmodel import crossover_density
    from repro_torch.estimator.backends import _matmul_policy
    _, est_mod, _, ops = mods
    brain = load_example("torch_brain_clustering")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(BRAIN_SEED + 1)
    omega0, labels, x, nbrs, side = brain.make_region_problem(
        BRAIN_SIDE, BRAIN_REGION, BRAIN_N, BRAIN_SEED, generator=gen)
    s = brain.sample_covariance(x, dev)
    n, p = x.shape
    del x
    torch.cuda.synchronize()
    print(f"brain: cortex {side}x{side} (p={p}), {labels.max() + 1} "
          f"regions of {BRAIN_REGION}x{BRAIN_REGION}, n={n} frames drawn "
          f"on the card, S in {time.perf_counter() - t0:.1f} s; lam1 grid "
          f"{brain.LAM1_GRID} x lam2 {brain.LAM2_GRID}: sqrt(log p / n) = "
          f"{np.sqrt(np.log(p) / n):.4f} here, "
          f"{np.sqrt(np.log(144) / 600):.4f} at the example's p=144 n=600")
    config = est_mod.SolverConfig(
        backend="reference", variant="cov", tol=1e-5, max_iters=250,
        use_pallas=True, sparse_matmul="auto", sparse_block=BLOCK,
        dtype="float64", device=str(dev))
    thr = _matmul_policy(config, p, p, dev).threshold
    print(f"brain: sparse_matmul='auto' threshold on the card "
          f"{thr:.4f} (CARD_BLOCK_MODEL); the data-sheet model's "
          f"{crossover_density(p, p, BLOCK):.4f}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = brain.run_pipeline(s, n, labels, nbrs, config=config)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    trials = 0
    for lam2, path in res.paths.items():
        for r in path:
            trials += r.ls_total
            deg = res.degrees[(r.lam1, lam2)]
            jac = " ".join(f"eps {e:g}: {res.scores[(r.lam1, lam2, e)]:.4f}"
                           for e in brain.EPS_GRID)
            print(f"brain: lam1={r.lam1} lam2={lam2} iters={r.iters} "
                  f"trials={r.ls_total} converged={r.converged} "
                  f"stalled={r.stalled} block density {r.block_density:.4f}"
                  f" wall {r.wall_time_s:.2f} s, {int(deg.sum()) // 2} "
                  f"edges; Jaccard {jac}")
            check(bool(torch.isfinite(r.omega).all()),
                  f"brain: non-finite estimate at lam1={r.lam1}")
    score, lam1, lam2, eps, ph, _ = res.best
    print(f"brain: persistent homology best Jaccard {score:.4f} (lam1={lam1}"
          f", lam2={lam2}, eps={eps}, {ph.max() + 1} clusters); label "
          f"propagation {res.lp_score:.4f} ({res.lp.max() + 1} clusters); "
          f"thresholded-cov baseline "
          + ", ".join(f"keep {k}: {v:.4f}" for k, v in res.baseline.items())
          + f" (best {res.baseline_best:.4f})")
    print(f"brain: path wall {res.path_wall_s:.2f} s ({trials} trials, "
          f"{1e3 * res.path_wall_s / trials:.1f} ms/trial), graphs on the "
          f"card {res.graph_wall_s:.2f} s, host clustering "
          f"{res.cluster_wall_s:.2f} s, pipeline {wall:.2f} s; peak "
          f"{peak / 2**30:.1f} GiB; launches {launches}")
    try:
        brain.check_result(res)
    except AssertionError as exc:
        fail(f"brain: {exc}")
    check_prox_launches(launches, trials, "brain")
    check(launches["blocksparse_matmul"] > 0,
          "brain: kernel 2 never ran on the pipeline's path")
    chosen = res.paths[lam2].reports[
        [r.lam1 for r in res.paths[lam2]].index(lam1)]
    del res
    torch.cuda.empty_cache()

    # the chosen point cold: through the kernels, and at the reference
    # example's own config (dense, no kernel)
    cold = {}
    for name, kw in (("kernels", dict(use_pallas=True, sparse_matmul="auto",
                                      sparse_block=BLOCK)),
                     ("dense", {})):
        cfg = est_mod.SolverConfig(backend="reference", variant="cov",
                                   tol=1e-5, max_iters=250, dtype="float64",
                                   device=str(dev), **kw)
        ops.reset_launches()
        rep = est_mod.ConcordEstimator(lam1=lam1, lam2=lam2, config=cfg) \
            .fit_cov(s, n_samples=n).report_
        cold[name] = rep
        print(f"brain cross-check: cold {name} lam1={lam1} lam2={lam2}: "
              f"iters={rep.iters} trials={rep.ls_total} converged="
              f"{rep.converged} wall {rep.wall_time_s:.2f} s launches "
              f"{dict(ops.LAUNCHES)}")
        if name == "dense":
            check(not any(ops.LAUNCHES.values()),
                  "brain: the dense cross-check launched a kernel")
    dense = cold["dense"].omega
    print(f"brain cross-check: cold kernels vs cold dense: "
          f"{support_agreement(clustering, cold['kernels'].omega, dense, brain.SUPPORT_TOL)}")
    print(f"brain cross-check: the path's warm point vs cold dense: "
          f"{support_agreement(clustering, chosen.omega, dense, brain.SUPPORT_TOL)}")
    check(cold["dense"].converged, "brain: the dense cross-check did not "
          "converge")
    del cold, chosen, dense, s
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 16: analysis (repro_torch.analysis on the card)
# ---------------------------------------------------------------------------

def analysis_fuzz(torch, kman, ops, dev) -> None:
    """(a) the differential fuzzer over every configs and card_configs
    entry in each declared dtype, at FUZZ_SEEDS seeds, each case under the
    fuzzer's guard: every case passes and every kernel launched."""
    from repro_torch.analysis import kernelfuzz
    ops.reset_launches()
    t0 = time.perf_counter()
    cases, worst, guarded = {}, {}, {}
    failed = []
    for seed in range(FUZZ_SEEDS):
        results = kernelfuzz.fuzz_entries(kman.KERNEL_ENTRIES, seed=seed,
                                          device=dev)
        failed += kernelfuzz.failures(results)
        for r in results:
            cases[r.entry] = cases.get(r.entry, 0) + 1
            worst[r.entry] = max(worst.get(r.entry, 0.0), r.max_abs_diff)
            guarded[r.entry] = guarded.get(r.entry, 0) + (r.output
                                                          == "<guard>")
    secs = time.perf_counter() - t0
    launched = dict(ops.LAUNCHES)
    for e in kman.KERNEL_ENTRIES:
        n = e["name"]
        print(f"analysis fuzz {n}: {len(kernelfuzz.entry_cases(e))} cases "
              f"x {FUZZ_SEEDS} seeds, {guarded[n]} guarded, {cases[n]} "
              f"checks, largest max_abs_diff {worst[n]:.3e}, launches "
              f"{launched[n]}")
    print(f"analysis fuzz: {sum(cases.values())} checks, {len(failed)} "
          f"failures, {secs:.1f} s")
    for r in failed[:10]:
        print(f"  {r.render()}")
    check(not failed, f"{len(failed)} fuzz case(s) failed on the card")
    check(all(guarded[e["name"]] == FUZZ_SEEDS * len(
        kernelfuzz.entry_cases(e)) for e in kman.KERNEL_ENTRIES),
          f"the fuzzer's guard did not run on every case: {guarded}")
    check(all(launched[e["name"]] > 0 for e in kman.KERNEL_ENTRIES),
          f"the fuzzer did not launch every kernel: {launched}")


def analysis_kcheck(kman, dev) -> None:
    """(b') the kernels' checked build (ROADMAP C3): first its five
    negative controls, each of which must trip its rule (one under
    jitter), then every configs and card_configs case at seed 0 in each
    declared dtype, unjittered and under 3 jitter seeds: 0 findings
    (CA401-CA403), no failure, every output element stored exactly once
    and the outputs bit-identical across the jitter seeds."""
    from repro_torch.analysis import kernelpass
    t0 = time.perf_counter()
    probe_results = kernelpass.probes(device=dev)
    for pr in probe_results:
        rules = sorted({f.rule for f in pr.findings})
        first = next((f for f in pr.findings if f.rule == pr.rule), None)
        print(f"analysis kcheck probe {pr.probe}: must trip {pr.rule}, "
              f"found {rules} in {pr.seconds:.2f} s"
              + (f" — {first.message}" if first else ""))
    check(all(p.tripped for p in probe_results),
          "a kcheck probe did not trip its rule: "
          + ", ".join(p.probe for p in probe_results if not p.tripped))
    t1 = time.perf_counter()
    cases = kernelpass.kcheck(seed=0, device=dev)
    for e in kman.KERNEL_ENTRIES:
        mine = [c for c in cases if c.entry == e["name"]]
        print(f"analysis kcheck {e['name']}: {len(mine)} cases, "
              f"{sum(c.launches for c in mine)} launches, "
              f"{sum(c.accesses for c in mine)} checked accesses, worst "
              f"write count {max(c.worst_count for c in mine)}, "
              f"{sum(c.jitter_runs for c in mine)} jitter runs, "
              f"{sum(len(c.findings) for c in mine)} findings, "
              f"{sum(len(c.failures) for c in mine)} failures, "
              f"{sum(c.seconds for c in mine):.1f} s")
    bad = [c for c in cases if not c.ok]
    for c in bad[:10]:
        for f in c.findings[:3]:
            print(f"  {f.render()}")
        for why in c.failures[:3]:
            print(f"  {c.entry} [{c.config}]: {why}")
    print(f"analysis kcheck: {len(probe_results)} probes in "
          f"{t1 - t0:.1f} s, {len(cases)} cases in "
          f"{time.perf_counter() - t1:.1f} s, {len(bad)} not clean")
    check(not bad, f"{len(bad)} kcheck case(s) not clean on the card")
    check(all(c.worst_count == 1 for c in cases),
          "an output element was stored more than once")
    check(all(c.jitter_runs == len(kernelpass.JITTER_SEEDS) for c in cases),
          "a kcheck case missed a jitter run")


def analysis_sanitize(dev) -> None:
    """(b) compute-sanitizer memcheck, racecheck and initcheck over the
    seed-0 cases (``--sanitize`` only): each must print a clean summary;
    an error, a tool that refuses the card or a missing tool fails."""
    from repro_torch.analysis import kernelpass
    for tool in kernelpass.SANITIZER_TOOLS:
        res = kernelpass.sanitize(tool, seed=0, device=dev, root=ROOT)
        print(f"analysis sanitize {res.render()}")
        check(res.ok, f"compute-sanitizer {tool}: {res.status}, "
                      f"{res.errors} error(s)\n{res.tail[-3000:]}")


def analysis_static() -> None:
    """(c) the CLI's default run (AST engine over the port, dispatch
    engine on the card, CA405 over the registry): 0 new findings against
    analysis_baseline_torch.json."""
    from repro_torch.analysis import cli
    rc = cli.main(["--root", str(ROOT)])
    check(rc == 0, f"python -m repro_torch.analysis exited {rc}")


def analysis_dispatch(torch, ops, dev) -> None:
    """(d) the dispatch engine on the card at f64: no finding (no CA201
    downcast, no broken entry, obs changes no op); its host-sync census
    per entry."""
    from repro_torch.analysis import dispatchpass, manifest
    from repro_torch.analysis.rules import DEFAULT_PROFILE
    ops.reset_launches()
    t0 = time.perf_counter()
    findings, records = dispatchpass.run_entries(
        manifest.load_entries(), DEFAULT_PROFILE, dev)
    secs = time.perf_counter() - t0
    for r in records:
        print(f"analysis dispatch {r['entry']}: {r.get('ops', 0)} ops, "
              f"{r.get('syncs', 0)} syncs")
    print(f"analysis dispatch: {len(records)} entries on {dev} in "
          f"{secs:.1f} s, kernel launches {dict(ops.LAUNCHES)}")
    for f in findings:
        print(f"  {f.render()}")
    check(not findings, f"the dispatch engine found {len(findings)} "
                        f"finding(s) on the card")


def analysis_census(torch, dev) -> dict:
    """PERF.md section 2's host syncs, counted by the dispatch engine on
    the card: the sequential trial's syncs (the marginal count between
    two solves of 3 and 6 iterations, sparse_matmul on and off) and the
    batched engine's (1 per flat step in ``_apply_trial``, 1 per segment
    that finishes a lane in ``harvest``, at most one per lane, and 1 per
    solve: the lane order's read of the lam1 grid)."""
    from repro_torch.analysis.dispatchpass import record
    from repro_torch.core import batch, matops, prox
    p = CENSUS_P
    idx = torch.arange(p, device=dev)
    band = (idx[:, None] - idx[None, :]).abs() <= 1
    s = torch.eye(p, dtype=torch.float64, device=dev) + 0.3 * band
    policy = matops.MatmulPolicy(mode="on", block_size=CENSUS_BLOCK,
                                 threshold=0.5)
    out = {}
    for mode, pol, want in (("on", policy, 2), ("off", None, 1)):
        runs = []
        for iters in (3, 6):
            res, c = record(prox.solve_reference, s, 0.1, tol=0.0,
                            max_iters=iters, max_ls=8, sparse_matmul=pol,
                            use_kernels=True)
            runs.append((res.ls_total, c.syncs, dict(c.sync_sites)))
        (t1, s1, _), (t2, s2, sites) = runs
        rate = Fraction(s2 - s1, t2 - t1)
        _, debug = count_syncs(torch, lambda: prox.solve_reference(
            s, 0.1, tol=0.0, max_iters=6, max_ls=8, sparse_matmul=pol,
            use_kernels=True))
        print(f"analysis census sequential sparse_matmul={mode}: {t1} / {t2} "
              f"trials, {s1} / {s2} syncs, {float(rate)} per trial "
              f"(sync debug mode: {debug}); sites {sites}")
        check(rate == want, f"sequential {mode}: {float(rate)} syncs per "
                            f"trial, PERF.md section 2 says {want}")
        out[mode] = {"trials": t2, "syncs": s2, "per_trial": float(rate),
                     "debug": debug}
    lanes = [0.3, 0.2, 0.15, 0.1]
    (res, st), c = record(batch.solve_path_batched, s, lanes, tol=1e-6,
                          max_iters=40, max_ls=8, schedule="compact",
                          chunk=3, use_pallas=True, return_stats=True)
    steps = len(st.capacities)
    sites = dict(c.sync_sites)
    per_step = sites.get("src/repro_torch/core/batch.py:_apply_trial", 0)
    harvests = sites.get("src/repro_torch/core/batch.py:harvest", 0)
    per_solve = c.syncs - per_step - harvests
    print(f"analysis census batched: {len(lanes)} lanes, {steps} flat steps, "
          f"{st.segments} segments, {c.syncs} syncs; sites {sites}")
    check(per_step == steps and 1 <= harvests <= len(lanes)
          and per_solve == 1,
          f"batched: {per_step} step syncs for {steps} flat steps, "
          f"{harvests} harvests, {per_solve} more per solve")
    out["batched"] = {"steps": steps, "segments": st.segments,
                      "harvests": harvests, "syncs": c.syncs}
    return out


def analysis_phase(torch, kman, ops, dev, sanitize: bool) -> None:
    analysis_fuzz(torch, kman, ops, dev)
    torch.cuda.empty_cache()
    analysis_kcheck(kman, dev)
    torch.cuda.empty_cache()
    if sanitize:
        analysis_sanitize(dev)
    else:
        print("analysis sanitize: not run (opt-in with --sanitize, on a "
              "card compute-sanitizer supports; a refusal fails)")
    analysis_static()
    analysis_dispatch(torch, ops, dev)
    analysis_census(torch, dev)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: timing
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 17: the dry run
# ---------------------------------------------------------------------------

def dryrun_cli_start() -> list:
    """Start the CLI's DRY_CELLS as subprocesses (CPU work: fake tensors
    in a fake process group of 256 / 512 ranks, so never in this
    process, whose groups are real), each writing its records under
    DRY_DIR.  Returns [(tag, process, out file, want records)]."""
    shutil.rmtree(DRY_DIR, ignore_errors=True)
    DRY_DIR.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = []
    for tag, argv, n in DRY_CELLS:
        out = DRY_DIR / f"torch_dryrun_{tag}.jsonl"
        log = open(DRY_DIR / f"{tag}.log", "w")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
               "--out", str(out)]
        procs.append((tag, subprocess.Popen(cmd, env=env, cwd=ROOT,
                                            stdout=log,
                                            stderr=subprocess.STDOUT),
                      out, n, log))
    return procs


def dryrun_cli_finish(procs, t0: float) -> None:
    """Wait for the CLI's cells (killing any past DRY_CLI_TIMEOUT): each
    exits 0 with its records, every key of the reference's record; the
    flash cell's kernel-4 flops equal the visible-pair closed form of
    the kernel-4 calls its step made."""
    from repro_torch.kernels import flash_attention as fa
    recs = {}
    for tag, proc, out, n, log in procs:
        try:
            rc = proc.wait(timeout=max(1.0, DRY_CLI_TIMEOUT
                                       - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "killed"
        log.close()
        text = (DRY_DIR / f"{tag}.log").read_text()
        print(f"dryrun (b) {tag}: exit {rc}; "
              + " | ".join(ln.strip() for ln in text.splitlines()
                           if ln.startswith(("==", "   memory",
                                             "   per-device",
                                             "   roofline", "dry-run"))))
        check(rc == 0, f"dryrun (b) {tag}: exit {rc}\n{text[-3000:]}")
        rows = [json.loads(x) for x in out.read_text().splitlines()]
        check(len(rows) == n, f"dryrun (b) {tag}: {len(rows)} records, "
              f"want {n}")
        for r in rows:
            missing = DRY_REF_KEYS - set(r)
            check(not missing, f"dryrun (b) {tag}: keys {missing} missing")
        recs[tag] = rows
    from repro_torch import configs
    (flash,) = recs["flash"]
    cfg = configs.get(flash["arch"])
    length = configs.SHAPES[flash["shape"]]["seq_len"]
    calls = flash["kernel_calls"].get("flash_attention", 0)
    got = flash["kernel_flops"].get("flash_attention", 0)
    b = flash["rows_per_dev"]
    want = calls * fa.flops((b, cfg.n_heads, length, cfg.hd),
                            (b, cfg.n_kv, length, cfg.hd), causal=True,
                            window=cfg.window)
    print(f"dryrun (b) flash: kernel-4 calls {calls}, flops {got} "
          f"(visible-pair closed form {want}); the cached prefill takes "
          f"the cached attention in both packages (transformer."
          f"apply_decoder_block: flash only without a cache), so its "
          f"logits are materialised: peak "
          f"{flash['total_bytes_per_dev'] / 1e9:.1f} GB, fits "
          f"{flash['fits_hbm']}")
    check(got == want, f"dryrun (b) flash: kernel-4 flops {got} != {want}")
    for r in recs["train"]:
        print(f"dryrun (b) train {r['mesh']} (route {r['route']}): "
              f"{r['flops']:.4e} flops, useful {r['useful_frac']:.3f}, "
              f"{r['hbm_bytes']:.4e} HBM bytes, {r['wire_bytes']:.4e} wire "
              f"bytes per device; bound {r['bound_s']:.3f} s "
              f"({r['dominant']}); peak {r['total_bytes_per_dev'] / 1e9:.2f}"
              f" GB; traced in {r['lower_s']} s")


#: the keys of the reference's dry-run record (``Roofline.row()``'s and
#: those ``lower_cell`` adds)
DRY_REF_KEYS = {
    "arch", "shape", "mesh", "flops", "hbm_bytes", "wire_bytes",
    "t_compute", "t_memory", "t_collective", "dominant", "bound_s",
    "useful_frac", "mfu_at_bound", "kind", "n_devices", "lower_s",
    "compile_s", "extrapolated", "arg_bytes_per_dev", "temp_bytes_per_dev",
    "out_bytes_per_dev", "alias_bytes_per_dev", "total_bytes_per_dev",
    "fits_hbm", "model_flops_per_dev"}


def dryrun_train(torch, dev, ops, smi) -> None:
    """(a) the dry run of TRAIN_ARCH's step at TRAIN_B x TRAIN_L (one
    process, fake CUDA tensors) against the same step on the card: the
    flops equal FlopCounterMode's around a real warm step, the peak
    within DRY_PEAK_TOL of ``max_memory_allocated`` (less what earlier
    phases still hold); the roofline bound beside the measured warm
    wall."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import lm, transformer
    from repro_torch.train import optim
    cfg = configs.get(TRAIN_ARCH)
    ops.reset_launches()
    dry = dryrun.trace_step(cfg, "train", TRAIN_B, TRAIN_L, device="cuda")
    check(not any(ops.LAUNCHES.values()),
          f"dryrun (a): the dry run launched {ops.LAUNCHES}")
    print(f"dryrun (a) predicted ({dry['wall_s']:.1f} s on the host): "
          f"{dry['flops']:.6e} flops, {dry['hbm_bytes']:.4e} HBM bytes, "
          f"peak {dry['peak_bytes'] / 2**30:.3f} GiB (state and batch "
          f"{dry['arg_bytes'] / 2**30:.3f} GiB)")
    # what earlier phases still hold: not this step's, so not predicted
    held = torch.cuda.memory_allocated()
    params = transformer.init_params(cfg, seed=0, max_len=TRAIN_L,
                                     device=dev)
    opt = optim.AdamW()
    state = lm.init_train_state(params, opt)
    step = lm.make_train_step(cfg, opt,
                              optim.cosine_schedule(3e-4, 100, 10000))
    gen = np.random.default_rng(0)
    toks = [torch.from_numpy(gen.integers(0, cfg.vocab, (TRAIN_B, TRAIN_L),
                                          dtype=np.int64)).to(
        device=dev, dtype=torch.int32) for _ in range(2)]
    batch = lm.Batch(toks[0], toks[1])
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    del metrics
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as fc:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    flops = fc.get_total_flops()
    del metrics
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    warm = time.perf_counter() - t0
    check(np.isfinite(loss), f"dryrun (a): loss {loss}")
    roof = roofline.build_roofline(
        cfg.name, f"train {TRAIN_B}x{TRAIN_L}", "1", cfg, "train", TRAIN_L,
        TRAIN_B, 1, {"flops": dry["flops"],
                     "bytes accessed": dry["hbm_bytes"]}, None, None)
    err = abs(dry["peak_bytes"] - peak) / peak
    print(f"dryrun (a) measured on {smi}: first step {first:.3f} s, warm "
          f"{warm:.3f} s, loss {loss:.6f}; {flops:.6e} flops "
          f"(FlopCounterMode, a warm step); peak {peak / 2**30:.3f} GiB "
          f"(max_memory_allocated less {held / 2**30:.3f} GiB that earlier "
          f"phases hold; {(base - held) / 2**30:.3f} GiB of the step's own "
          f"live before it)")
    print(f"dryrun (a) predicted vs measured: flops equal "
          f"{dry['flops'] == flops}; peak {dry['peak_bytes'] / 2**30:.3f} "
          f"vs {peak / 2**30:.3f} GiB ({100 * err:.2f}% off, limit "
          f"{100 * DRY_PEAK_TOL:.0f}%)")
    print(f"dryrun (a) roofline at H100 data-sheet constants: compute "
          f"{roof.t_compute:.3f} s, memory {roof.t_memory:.3f} s "
          f"(unfused eager bytes) => bound {roof.bound:.3f} s "
          f"({roof.dominant}); measured warm {warm:.3f} s = "
          f"{100 * roof.bound / warm:.1f}% of the roofline; MFU "
          f"{100 * roof.model_flops / warm / roofline.PEAK_FLOPS:.2f}% "
          f"(model flops {roof.model_flops:.4e}), useful "
          f"{roof.useful_fraction:.3f}")
    check(dry["flops"] == flops, f"dryrun (a): dry-run flops "
          f"{dry['flops']} != the real step's {flops}")
    check(err <= DRY_PEAK_TOL, f"dryrun (a): predicted peak "
          f"{dry['peak_bytes']} off the card's {peak} by {100 * err:.1f}%")
    dryrun_flash(torch, dev, ops, cfg, state.params)


def dryrun_flash(torch, dev, ops, cfg, params) -> None:
    """(a') the cache-free forward (``lm.loss_fn``, no gradient) at the
    lm phase's shape through kernel 4 (``attention_impl="flash"``), on
    the card and on fake tensors: kernel 4 launched once per layer (its
    count zeroed before, read after), its flops in FlopCounterMode by the
    custom op's rule, equal on both and to the visible-pair closed
    form."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    cfgf = cfg.with_(attention_impl="flash")
    op = torch.ops.repro_torch.flash_attention
    gen = np.random.default_rng(1)
    toks = torch.from_numpy(gen.integers(0, cfg.vocab, (LM_B, LM_L),
                                         dtype=np.int64)).to(
        device=dev, dtype=torch.int32)
    ops.reset_launches()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        total, _ = lm.loss_fn(cfgf, params, lm.Batch(toks, toks))
        torch.cuda.synchronize()
    launched = ops.LAUNCHES["flash_attention"]
    real = fc.get_flop_counts()["Global"].get(op, 0)
    with FakeTensorMode():
        fake = dryrun.fake_params(cfgf, LM_L, torch.device("cuda"))
        ft = torch.empty((LM_B, LM_L), dtype=torch.int32, device="cuda")
        counters = dryrun.StepCounters(count_bytes=False)
        with FlopCounterMode(display=False) as ffc, counters:
            lm.loss_fn(cfgf, fake, lm.Batch(ft, ft))
    dry = ffc.get_flop_counts()["Global"].get(op, 0)
    want = cfg.n_layers * fa.flops((LM_B, cfg.n_heads, LM_L, cfg.hd),
                                   (LM_B, cfg.n_kv, LM_L, cfg.hd),
                                   causal=True, window=cfg.window)
    print(f"dryrun (a') loss_fn {LM_B} x {LM_L} through kernel 4: loss "
          f"{float(total):.6f}, {launched} launches (real), "
          f"{counters.kernel_calls.get('flash_attention', 0)} calls "
          f"(fake); kernel-4 flops real {real}, dry {dry}, closed form "
          f"{want}")
    check(launched == cfg.n_layers, f"dryrun (a'): {launched} kernel-4 "
          f"launches, want {cfg.n_layers}")
    check(real == dry == want, f"dryrun (a'): kernel-4 flops real {real}, "
          f"dry {dry}, closed form {want}")
    check(np.isfinite(float(total)), f"dryrun (a'): loss {float(total)}")


def dryrun_phase(torch, dev, ops, smi) -> None:
    """(b) the CLI's cells start first, on the host's cores, while (a)
    and (a') run on the card; then (b) is waited for."""
    t0 = time.perf_counter()
    procs = dryrun_cli_start()
    try:
        dryrun_train(torch, dev, ops, smi)
        torch.cuda.empty_cache()
        print(f"dryrun (a)+(a'): part wall {time.perf_counter() - t0:.1f} s")
        dryrun_cli_finish(procs, t0)
    finally:
        for _, proc, _, _, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    print(f"dryrun: phase wall {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(DRY_DIR, ignore_errors=True)


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
    from repro_torch.core.objective import dot, gradient_from_w
    omega, s = state["omega"], state["s"]
    p, bs = omega.shape[0], BLOCK
    gm = -(-p // bs)
    measured = {}
    # kernel 1 at a main-path trial: z = Omega - tau * grad, alpha = tau*lam1
    tau = 0.5
    grad = gradient_from_w(omega, omega @ s, state["lam2"])
    z = omega - tau * grad
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
    del z

    # its trial entry at the same trial (both bodies), against the unfused
    # trial it replaces: z, kernel 1, d = cand - omega, three BLAS dots
    def unfused(w):
        cand, *_, bnnz = ops.fused_prox_stats(omega - tau * grad, None,
                                              alpha, weights=w,
                                              block=(bs, bs))
        diff = cand - omega
        return dot(diff, diff), dot(diff, grad), dot(cand, cand), bnnz

    for name, w in (("fused_prox_stats[trial]", None),
                    ("fused_prox_stats[trial][weighted]", wz)):
        ms = time_ms(torch, lambda: ops.fused_prox_trial(
            omega, grad, tau, alpha, weights=w, block=(bs, bs)), 20)
        plain = time_ms(torch, lambda: ref.fused_prox_trial(
            omega, grad, tau, alpha, weights=w, block=(bs, bs)), 5, 1)
        # Omega, grad (and w) in, cand out, 4 stats a tile
        b, by = bound((3 + (w is not None)) * p * p * 8 + gm * gm * 4 * 8,
                      (13.0 + (w is not None)) * p * p, "float64")
        measured[name] = {
            "ms": ms, "plain_ms": plain,
            "unfused_ms": time_ms(torch, lambda: unfused(w), 10),
            "bound_ms": b, "bound_by": by, "library_ms": None}
    del grad, wz
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
        # each TPU body it replaces, then the port's own trial entry
        # (unweighted and weighted), each with its own launch count
        bodies = [(e["name"] + ("[weighted]" if body else ""), site)
                  for body, site in enumerate(e["replaces"])]
        trial = [(e["name"] + "[trial]" + w, None) for w in ("", "[weighted]")]
        for name, site in bodies + trial:
            if name not in measured:
                continue
            m = measured[name]
            lib = ("" if m["library_ms"] is None
                   else f", library {m['library_ms']:.3f} ms")
            if m.get("library_bsr_ms") is not None:
                lib += f", BSR library {m['library_bsr_ms']:.3f} ms"
            if m.get("unfused_ms") is not None:
                lib += f", unfused trial {m['unfused_ms']:.3f} ms"
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
    est = est_mod.ConcordEstimator(penalty=penalty.PenaltySpec.l1(0.3, 0.05),
                                   config=main_cell_config(est_mod))
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
                         "gram,lm,dist,telemetry,serve,pathmode,cross,"
                         "timing,calibrate,brain,lmserve,zoo,train,trainmp,"
                         "servemp,analysis,dryrun "
                         "(default: "
                         "all; "
                         "device and build always run; telemetry and "
                         "pathmode need main)")
    ap.add_argument("--profile", action="store_true",
                    help="after the phases, profile one warm main-path fit "
                         "and one batched path (needs the main phase), "
                         "one loss_fn (needs the lm phase) and one serve "
                         "group against its requests one by one (needs "
                         "the serve phase); the gram phase profiles one "
                         "prep's streaming pass, the lmserve phase 8 "
                         "decode steps of danube and of OLMoE, the zoo "
                         "phase 8 decode steps of each of its models, the "
                         "train phase one warm danube train step")
    ap.add_argument("--sanitize", action="store_true",
                    help="the analysis phase also runs compute-sanitizer "
                         "memcheck, racecheck and initcheck over the fuzz "
                         "cases; an error or a refused card fails")
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
    checked_builds = build_kernels(build)
    errs, state, lm_state, launches, measured = {}, None, None, {}, {}
    serve_stats = None
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
    if run("telemetry") and state is not None:
        phase("telemetry")
        telemetry_phase(torch, mods, dev, state)
        torch.cuda.empty_cache()
    if run("serve"):
        phase("serve")
        serve_stats = serve_phase(torch, dev)
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
    if args.profile and serve_stats is not None:
        phase("profile serve")
        profile_serve(torch, mods, dev, serve_stats)
    if run("calibrate"):
        phase("calibrate")
        calibrate_phase(torch, mods, ref, dev)
    if run("brain"):
        phase("brain")
        brain_phase(torch, mods, dev)
    if run("lmserve"):
        phase("lmserve")
        lmserve_phase(torch, dev, ops, lm_state or {}, args.profile)
        lm_state = None
    if run("zoo"):
        phase("zoo")
        zoo_phase(torch, dev, ops, args.profile)
        torch.cuda.empty_cache()
    train_losses = None
    if run("train"):
        phase("train")
        train_losses = train_phase(torch, dev, ops, args.profile)
        torch.cuda.empty_cache()
    if run("trainmp"):
        phase("trainmp")
        trainmp_phase(torch, dev, ops, train_losses)
        torch.cuda.empty_cache()
    if run("servemp"):
        phase("servemp")
        servemp_phase(torch, dev)
        torch.cuda.empty_cache()
    if run("analysis"):
        phase("analysis")
        wait_checked(build, checked_builds)
        analysis_phase(torch, kman, ops, dev, args.sanitize)
    if run("dryrun"):
        phase("dryrun")
        dryrun_phase(torch, dev, ops, smi)
        torch.cuda.empty_cache()
    if measured:
        rows = kernel_rows(kman, measured, errs, launches, smi)
        print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
