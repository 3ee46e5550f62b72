"""``python -m repro_torch.obs.cli`` — inspect, diff, export and gate
observability artifacts.  Port of ``repro.obs.cli`` (``repro-obs``).

Subcommands:

  * ``print <trace>``       pretty-print a JSONL or Chrome-trace export
                            (written by either package)
  * ``diff <a> <b>``        per-span-name count/duration deltas between
                            two trace exports (regression triage)
  * ``export <in> <out>``   convert between the JSONL and Chrome-trace
                            formats (by file extension: ``.jsonl`` vs
                            ``.json``)
  * ``reconcile``           run a distributed solve with the comm watcher
                            armed and check measured == predicted comm
                            counts and bytes per (prim, axes) on every
                            rank; exit 1 on ANY divergence (the CI gate),
                            optionally exporting the Perfetto trace and
                            the reconciliation JSON (rank 0's).

``reconcile`` runs on the ranks of a process group, as
``launch.solve`` does: under torchrun it joins the group itself (NCCL on
the card), one grid position per process,

  torchrun --nproc-per-node 1 -m repro_torch.obs.cli reconcile

and outside one it runs the one-process grid.  ``main(argv,
device="cpu")`` reconciles on the host, inside a gloo group when the
caller has joined one.  Every rank prints its own report.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

from .trace import load_chrome, load_jsonl


def _load_any(path: str):
    """A trace export, whichever format: Chrome-trace JSON documents are
    objects with a ``traceEvents`` key, JSONL files are one span/line."""
    with open(path, encoding="utf-8") as f:
        head = f.read(4096)
    if head.lstrip().startswith("{") and '"traceEvents"' in head:
        return load_chrome(path)
    return load_jsonl(path)


def _by_name(spans) -> dict:
    agg: dict = defaultdict(lambda: {"count": 0, "duration": 0.0})
    for s in spans:
        agg[s.name]["count"] += 1
        agg[s.name]["duration"] += s.duration
    return dict(agg)


def cmd_print(args) -> int:
    spans = _load_any(args.trace)
    print(f"{args.trace}: {len(spans)} events")
    for s in sorted(spans, key=lambda s: s.t_start):
        extras = " ".join(f"{k}={v}" for k, v in sorted(s.args.items()))
        kind = "span " if s.phase == "span" else "event"
        print(f"  {s.t_start:12.6f}s {kind} {s.cat}/{s.name:<24} "
              f"{s.duration * 1e3:9.3f}ms  {extras}")
    agg = _by_name(spans)
    print("by name:")
    for name, row in sorted(agg.items(),
                            key=lambda kv: -kv[1]["duration"]):
        print(f"  {name:<28} x{row['count']:<5} "
              f"{row['duration'] * 1e3:10.3f}ms total")
    return 0


def cmd_diff(args) -> int:
    a, b = _by_name(_load_any(args.a)), _by_name(_load_any(args.b))
    print(f"{'span':<28} {'count A->B':>14} {'duration A->B (ms)':>26}")
    for name in sorted(set(a) | set(b)):
        ra = a.get(name, {"count": 0, "duration": 0.0})
        rb = b.get(name, {"count": 0, "duration": 0.0})
        print(f"{name:<28} {ra['count']:>6} -> {rb['count']:<5} "
              f"{ra['duration'] * 1e3:>11.3f} -> {rb['duration'] * 1e3:.3f}")
    return 0


def cmd_export(args) -> int:
    from .trace import Tracer
    spans = _load_any(args.src)
    t = Tracer(mode="trace", capacity=max(len(spans), 1))
    for s in spans:
        t._record(s)
    if args.dst.endswith(".jsonl"):
        n = t.export_jsonl(args.dst)
    else:
        n = t.export_chrome(args.dst)
    print(f"wrote {n} events to {args.dst}")
    return 0


def cmd_reconcile(args, device=None) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..comm import group
    from ..comm.grid import Grid1p5D
    from ..core import distributed as fit_dist
    from ..device import resolve_device
    from .commwatch import CommWatch
    from .trace import get_tracer

    dev = resolve_device(device)
    joined = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if joined:
        dev = group.init_process_group(device)
    try:
        world, rank = group.world_size(), (dist.get_rank()
                                           if dist.is_initialized() else 0)
        n_dev = args.devices or world
        rng = np.random.default_rng(args.seed)
        x = rng.standard_normal((args.n, args.p))
        s = torch.as_tensor((x.T @ x) / args.n, device=dev)
        x = torch.as_tensor(x, device=dev)
        grid = Grid1p5D(n_dev, args.c_x, args.c_omega)
        tracer = get_tracer()
        reports = []
        with tracer.scoped("trace"):
            for variant in args.variants.split(","):
                fit = fit_dist.fit_cov if variant == "cov" \
                    else fit_dist.fit_obs
                with CommWatch() as watch:
                    with tracer.span(f"reconcile.{variant}", p=args.p,
                                     n_devices=n_dev):
                        fit(s if variant == "cov" else x, args.lam1,
                            grid=grid, max_iters=args.max_iters)
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
                reports.extend(watch.reconcile())
    finally:
        if joined:
            group.destroy_process_group()
    tag = f"[rank {rank}/{world}] " if world > 1 else ""
    for rep in reports:
        print(tag + rep.render().replace("\n", "\n" + tag))
        print()
    if rank == 0 and args.trace_out:
        tracer.export_chrome(args.trace_out)
        print(f"trace -> {args.trace_out}")
    if rank == 0 and args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump([r.to_json() for r in reports], f, indent=2)
        print(f"reconciliation -> {args.json_out}")
    if not all(r.ok for r in reports):
        print(f"{tag}FAIL: measured collective schedule diverges from the "
              f"analytic comm_volume prediction", file=sys.stderr)
        return 1
    print(f"{tag}OK: measured == predicted for every (prim, axes)")
    return 0


def main(argv=None, *, device=None) -> int:
    """The CLI; ``device`` (not a flag: the reference has none) picks
    where ``reconcile`` solves — ``None`` is the CUDA card."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.cli",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("print", help="pretty-print a trace export")
    p.add_argument("trace")
    p.set_defaults(fn=cmd_print)

    p = sub.add_parser("diff", help="diff two trace exports by span name")
    p.add_argument("a")
    p.add_argument("b")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser("export", help="convert jsonl <-> chrome trace")
    p.add_argument("src")
    p.add_argument("dst")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser(
        "reconcile",
        help="distributed solve with the comm watcher armed on every "
             "rank; exit 1 on measured != predicted counts or bytes")
    p.add_argument("--devices", type=int, default=None,
                   help="grid size (default: the process group's world "
                        "size, 1 outside one)")
    p.add_argument("--c-x", type=int, default=1)
    p.add_argument("--c-omega", type=int, default=1)
    p.add_argument("--p", type=int, default=32)
    p.add_argument("--n", type=int, default=48)
    p.add_argument("--lam1", type=float, default=0.3)
    p.add_argument("--max-iters", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--variants", default="cov,obs",
                   help="comma list of cov/obs")
    p.add_argument("--trace-out", default=None,
                   help="write the Perfetto trace here (rank 0)")
    p.add_argument("--json-out", default=None,
                   help="write the reconciliation rows here (rank 0)")
    p.set_defaults(fn=lambda a: cmd_reconcile(a, device))

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
