"""Serving launcher: batch concurrent requests through one engine.  Port
of ``repro.launch.serve``, with the same flags:

  * ``--workload lm`` (the default): batched prefill and greedy decode
    over the cache, for every family of the zoo (``serve_batch``);
    Whisper's encoder reads stub frames, zeros of (B, enc_len, d).

      PYTHONPATH=src python -m repro_torch.launch.serve \\
          --arch h2o-danube-1.8b --batch 4 --prompt-len 32 --gen 32

  * ``--workload concord``: a queue of concurrent estimation requests
    (multi-tenant / multi-subject solves, one dataset + penalty each) is
    bucketed by shape, difficulty-sorted within each bucket by the cost
    model's predicted iteration count (groups converge together, so the
    batched engine's lane compaction stays effective on mixed-difficulty
    queues), and drained in micro-batches of ``--batch`` through the
    batched multi-problem engine (``estimator.fit_batch`` ->
    ``core.batch``).  Partial groups are padded to the full batch size so
    every group runs at one shape.  Reports batched vs sequential
    throughput (requests/s) and per-request latency.

      PYTHONPATH=src python -m repro_torch.launch.serve --workload concord \\
          --requests 12 --batch 4 --p 64 --n 160

Both run on the CUDA card; ``serve_concord(args, device="cpu")`` and
``main(argv, device="cpu")`` run them on the host, and ``serve_batch``
runs where its parameters and prompts are.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch

from ..census import span
from ..device import resolve_device, synchronize


class ConcordServeStats(NamedTuple):
    """What one concord-workload drain did — returned (not just printed)
    so the micro-batching behavior is testable."""
    reports: list               # one FitReport per request, input order
    lam1s: np.ndarray           # the per-request penalties served
    n_groups: int               # fit_batch calls (ceil(R/batch))
    group_shapes: list          # (B, n, p) of each fit_batch call
    t_batched: float
    t_sequential: float
    max_gap: float              # max |Ω_batched - Ω_seq| across queue
    order: np.ndarray = None    # difficulty-sorted drain order (request
                                # indices, hardest first within each
                                # shape bucket)
    queue_wait_s: np.ndarray = None  # per-request: drain start -> its
                                     # group's fit_batch call
    solve_wall_s: np.ndarray = None  # per-request: its group's fit_batch
                                     # wall (the request rode that batch)
    latency_s: np.ndarray = None     # per-request end-to-end =
                                     # queue_wait_s + solve_wall_s


def _difficulty_buckets(shapes, lam1s, bsz: int):
    """Group request indices for the micro-batched drain: bucket by data
    shape, difficulty-sort each bucket by the cost model's predicted
    iteration count (hardest first — cheap requests are not padded up to
    a straggler's line search), then cut consecutive groups of ``bsz``.
    Yields index lists of length <= bsz; similar-difficulty neighbors
    land in the same group, so every group converges together and the
    batched engine's compaction keeps lanes live."""
    from ..core.costmodel import predict_path_iters

    iters = np.asarray(predict_path_iters(lam1s), np.float64)
    buckets: dict = {}
    for i, shape in enumerate(shapes):
        buckets.setdefault(tuple(shape), []).append(i)
    for idx in buckets.values():
        # stable sort: equal predictions keep arrival order
        ordered = [idx[k] for k in np.argsort(-iters[idx], kind="stable")]
        for lo in range(0, len(ordered), bsz):
            yield ordered[lo:lo + bsz]


def _mark(dev):
    """A point on ``dev``'s clock: a recorded CUDA event (no host wait),
    or the host clock on the CPU."""
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _seconds(a, b) -> float:
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) / 1e3


def serve_batch(cfg, params, prompts, gen: int, max_len: int,
                frames=None, *, stats=None):
    """Greedy-decode ``gen`` tokens for a batch of prompts.

    ``params`` is a ``DecoderLM`` (float32 master weights) and ``prompts``
    a (B, Lp) integer tensor on the same device; an enc-dec model also
    takes ``frames`` (B, enc_len, d), encoded once by the prefill.  The
    weights are cast to the compute dtype once, before the prefill (the
    reference casts them inside every jitted step; the cast is the same
    round-to-nearest-even, so the bits are the same).  The generated
    tokens stay on the device, and the decode loop reads nothing back, so
    the host never waits on the card.  Returns (B, gen) int32.

    With a dict ``stats``, also fills ``prefill_s`` (the prefill and its
    greedy token) and ``step_s`` (one entry per decode step), timed on
    the device's clock (CUDA events; the loop still waits for nothing
    until its end), ``logits`` (the prefill's last-position logits) and
    ``cache`` (the cache after the last step)."""
    from ..models import lm
    from ..models import transformer as T
    B, Lp = prompts.shape
    dev = prompts.device
    pc = lm.cast_params(cfg, params)
    cache = T.init_cache(cfg, B, max_len, device=dev)
    prefill = lm.make_prefill(cfg, max_len)
    decode = lm.make_decode_step(cfg)
    marks = [] if stats is not None else None
    if marks is not None:
        marks.append(_mark(dev))
    cache, logits = prefill(pc, cache, prompts, frames)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    if marks is not None:
        marks.append(_mark(dev))
    steps = torch.arange(Lp, Lp + gen - 1, device=dev)
    for i in range(gen - 1):
        cache, tok = decode(pc, cache, tok, steps[i])
        out.append(tok)
        if marks is not None:
            marks.append(_mark(dev))
    if marks is not None:
        synchronize(dev)
        stats.update(
            prefill_s=_seconds(marks[0], marks[1]),
            step_s=[_seconds(a, b) for a, b in zip(marks[1:-1], marks[2:])],
            logits=logits, cache=cache)
    return torch.stack(out, dim=1)                       # (B, gen)


def serve_concord(args, *, device=None):
    """Drain a queue of concurrent estimation requests in micro-batches.

    Each request is an (n, p) dataset plus its own lam1.  Requests are
    bucketed by shape, each bucket is difficulty-sorted by the cost
    model's predicted iteration count (``_difficulty_buckets``) so a
    group's lanes converge together, and consecutive groups of
    ``--batch`` solve as one batched call; partial groups are padded by
    repeating their final request (and the padding results dropped) so
    every group runs at the same shape.  A sequential drain of the same
    queue is timed as the baseline.  Every clock is read after a device
    sync, so the times are of work done, not of work queued.

    Runs on the CUDA card unless ``device="cpu"``; the requests are
    drawn on the host (``graphs.make_problem``, float32) as in the
    reference, and each group crosses to the device as one stack."""
    from ..core import graphs
    from ..estimator import ConcordEstimator, SolverConfig, fit_batch

    dev = resolve_device(device)
    rng = np.random.default_rng(args.seed)
    reqs = [graphs.make_problem("chain", args.p, args.n,
                                seed=args.seed + i).x
            for i in range(args.requests)]
    xs = np.stack(reqs)                          # one shape bucket
    lam1s = rng.uniform(0.12, 0.3, size=args.requests)
    obs_mode = getattr(args, "obs", "off")
    config = SolverConfig(backend="reference", variant="obs",
                          tol=args.tol, max_iters=args.max_iters,
                          obs=obs_mode, device=str(dev))
    bsz = max(1, args.batch)
    tracer = registry = None
    scope = contextlib.nullcontext()
    if obs_mode != "off":
        from ..obs.metrics import get_registry
        from ..obs.trace import get_tracer
        tracer = get_tracer()
        scope = tracer.scoped(obs_mode)
        registry = get_registry()

    with scope:
        # batched drain: difficulty/shape-bucketed groups, tail-padded to
        # bsz; reports scatter back to input order.  Per-request latency
        # splits into the time its group spent queued behind earlier
        # groups (queue wait) and its group's solve wall.
        synchronize(dev)
        drain0 = time.perf_counter()
        reports = [None] * args.requests
        queue_wait = np.zeros(args.requests)
        solve_wall = np.zeros(args.requests)
        group_shapes, order = [], []
        for group in _difficulty_buckets([x.shape for x in reqs], lam1s,
                                         bsz):
            order.extend(group)
            idx = group + [group[-1]] * (bsz - len(group))
            xg = torch.as_tensor(xs[idx], device=dev)
            group_shapes.append(tuple(xg.shape))
            g0 = time.perf_counter()
            with span("serve.group", cat="serve", level="summary",
                      requests=len(group), batch=bsz):
                rep = fit_batch(x=xg, lam1=lam1s[idx], lam2=args.lam2,
                                config=config)
                synchronize(dev)
            gw = time.perf_counter() - g0
            for i, r in zip(group, rep.reports):
                reports[i] = r
                queue_wait[i] = g0 - drain0
                solve_wall[i] = gw
                if registry is not None:
                    registry.histogram("repro_serve_queue_wait_seconds"
                                       ).observe(queue_wait[i])
                    registry.histogram("repro_serve_solve_wall_seconds"
                                       ).observe(solve_wall[i])
                    registry.histogram("repro_serve_latency_seconds"
                                       ).observe(queue_wait[i]
                                                 + solve_wall[i])
                if tracer is not None:
                    tracer.event("serve.request", cat="serve", request=i,
                                 queue_wait_s=float(queue_wait[i]),
                                 solve_wall_s=float(solve_wall[i]))
        t_batched = time.perf_counter() - drain0

        # sequential baseline: one solve per request
        est = ConcordEstimator(lam1=0.2, lam2=args.lam2, config=config)
        synchronize(dev)
        t0 = time.perf_counter()
        seq = []
        for i in range(args.requests):
            est.lam1 = float(lam1s[i])
            seq.append(est.fit(torch.as_tensor(xs[i], device=dev)).report_)
        synchronize(dev)
        t_sequential = time.perf_counter() - t0

    n_conv = sum(r.converged for r in reports)
    # one host pull for the whole agreement check, not one per request
    om_batched = torch.stack([r.omega for r in reports])
    om_seq = torch.stack([r.omega for r in seq])
    gap = float((om_batched - om_seq).abs().max())
    latency = queue_wait + solve_wall
    print(f"served {args.requests} requests (p={args.p}, n={args.n}) in "
          f"micro-batches of {bsz} on {dev}: batched {t_batched:.2f}s "
          f"({args.requests / t_batched:.2f} req/s) vs sequential "
          f"{t_sequential:.2f}s ({args.requests / t_sequential:.2f} req/s); "
          f"converged {n_conv}/{args.requests}; "
          f"max |Ω_batch - Ω_seq| {gap:.2e}")
    print(f"request latency: p50 {np.quantile(latency, .5):.3f}s "
          f"p99 {np.quantile(latency, .99):.3f}s "
          f"(queue wait p50 {np.quantile(queue_wait, .5):.3f}s, "
          f"solve wall p50 {np.quantile(solve_wall, .5):.3f}s)")
    if registry is not None:
        print(registry.to_prometheus())
    return ConcordServeStats(
        reports=reports, lam1s=lam1s, n_groups=len(group_shapes),
        group_shapes=group_shapes, t_batched=t_batched,
        t_sequential=t_sequential, max_gap=gap,
        order=np.asarray(order, np.int64),
        queue_wait_s=queue_wait, solve_wall_s=solve_wall,
        latency_s=latency)


def main(argv=None, *, device=None):
    """The CLI; ``device`` (not a flag: the reference has none) picks
    where either workload runs — ``None`` is the CUDA card."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="lm", choices=["lm", "concord"])
    ap.add_argument("--arch", default=None,
                    help="model config name (required for --workload lm)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="micro-batch size (both workloads)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    # concord-workload knobs
    ap.add_argument("--requests", type=int, default=12,
                    help="concord: queued estimation requests to drain")
    ap.add_argument("--p", type=int, default=64)
    ap.add_argument("--n", type=int, default=160)
    ap.add_argument("--lam2", type=float, default=0.05)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--max-iters", type=int, default=300)
    ap.add_argument("--obs", default="off",
                    choices=["off", "summary", "trace"],
                    help="concord: observability level (spans + request "
                         "latency histograms via repro_torch.obs)")
    args = ap.parse_args(argv)

    if args.workload == "concord":
        return serve_concord(args, device=device)
    if args.arch is None:
        ap.error("--arch is required for --workload lm")
    from .. import configs as C
    from ..models import transformer as T

    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    dev = resolve_device(device)
    max_len = args.prompt_len + args.gen
    params = T.init_params(cfg, seed=args.seed, max_len=max_len, device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)
    frames = (torch.zeros((args.batch, cfg.enc_len, cfg.d_model),
                          dtype=getattr(torch, cfg.dtype), device=dev)
              if cfg.enc_dec else None)
    synchronize(dev)
    t0 = time.perf_counter()
    toks = serve_batch(cfg, params, prompts, args.gen, max_len,
                       frames=frames)
    synchronize(dev)
    dt = time.perf_counter() - t0
    n = args.batch * args.gen
    print(f"generated {n} tokens in {dt:.2f}s ({n / dt:.1f} tok/s on {dev})")
    print("sample:", toks[0][:16].cpu().numpy())
    return toks


if __name__ == "__main__":
    main()
