"""Gram-prep launcher: reduce a row-stream of X to its (p, p) sufficient
statistic on disk, once, up front — the out-of-core front half of an
HP-CONCORD solve.  Port of ``repro.launch.gram``; the Gram accumulates on
the CUDA card.

  # synthesize a scenario stream (no X ever materialized) and prep it:
  PYTHONPATH=src python -m repro_torch.launch.gram prep \\
      --scenario scale_free --p 512 --n 200000 --transform standardize \\
      --out results/gram_sf

  # or prep existing .npy / raw shard files:
  PYTHONPATH=src python -m repro_torch.launch.gram prep \\
      --shards data/shards/ --transform rank --out results/gram_real

  # then solve from the artifact (no raw data needed ever again):
  PYTHONPATH=src python -m repro_torch.launch.solve --from-gram results/gram_sf

``prep`` writes ``OUT/S.npy`` (float64 Gram of the transformed data) and
``OUT/gram_meta.json`` (n, p, transform, stream stats, chunk accounting,
peak-memory proxy): the reference's artifact, key for key, so an artifact
prepped by either package is solved by the other.  The default chunk size
comes from the port's cost model (``core.costmodel.gram_chunk_rows`` on
the H100's 80 GB; the reference's default machine has 16 GB, so the two
packages' default chunks differ).  ``families`` lists the scenario
generators.  ``main(argv, device="cpu")`` runs on the host.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..core.costmodel import H100, gram_chunk_rows
from ..data import (
    available_families,
    available_transforms,
    compute_gram,
    make_scenario,
    open_shards,
)
from ..data.gram import RANK_BUDGET_BYTES, GramResult
from ..device import resolve_device

META_NAME = "gram_meta.json"


def save_gram(result: GramResult, out_dir: str, *, extra: dict | None = None
              ) -> str:
    """Write OUT/S.npy + OUT/gram_meta.json (mean/var ride in the meta so
    the artifact is self-contained for scoring new data later)."""
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "S.npy"), result.s.cpu().numpy())
    meta = result.to_meta()
    meta["mean"] = result.mean.tolist()
    meta["var"] = result.var.tolist()
    meta.update(extra or {})
    path = os.path.join(out_dir, META_NAME)
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
    return path


def load_gram(path: str, device=None) -> GramResult:
    """Reopen a ``prep`` artifact (a directory with S.npy + meta, or the
    S.npy path itself) as a :class:`GramResult` on ``device`` for
    ``fit_gram``."""
    dev = resolve_device(device)
    d = path if os.path.isdir(path) else os.path.dirname(path)
    meta_path = os.path.join(d, META_NAME)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"{meta_path} missing — a Gram artifact needs its metadata "
            f"sidecar (rerun launch.gram prep)")
    with open(meta_path) as f:
        meta = json.load(f)
    s = torch.as_tensor(np.load(os.path.join(d, "S.npy")), device=dev)
    p = s.shape[0]

    def vec(key, fill):
        return torch.as_tensor(np.asarray(meta.get(key, [fill] * p),
                                          np.float64), device=dev)

    return GramResult(
        s=s, n=int(meta["n"]), p=p, transform=meta.get("transform", "none"),
        mean=vec("mean", 0.0), var=vec("var", 1.0),
        n_chunks=int(meta.get("n_chunks", 1)),
        source_dtype=meta.get("source_dtype", "float64"))


def _prep(args, device) -> str:
    chosen = [bool(args.scenario), bool(args.npy), bool(args.shards)]
    if sum(chosen) != 1:
        raise SystemExit("pass exactly one of --scenario / --npy / --shards")
    dev = resolve_device(device)
    if args.scenario:
        sc = make_scenario(args.scenario, args.p, seed=args.seed,
                           cond=args.cond,
                           heavy_tail_df=args.heavy_tail_df, device=dev)
        p = sc.p
        chunk_rows = args.chunk_rows or gram_chunk_rows(p, machine=H100)
        data = sc.source(args.n, chunk_rows=chunk_rows, seed=args.seed + 1)
        src_desc = {"kind": "scenario", "family": sc.name,
                    "cond": sc.cond, "seed": args.seed,
                    "heavy_tail_df": args.heavy_tail_df}
    else:
        paths = args.npy.split(",") if args.npy else args.shards
        src = open_shards(paths, chunk_rows=args.chunk_rows or 4096)
        p = src.p
        chunk_rows = args.chunk_rows or gram_chunk_rows(p, machine=H100)
        data = open_shards(paths, chunk_rows=chunk_rows)
        src_desc = {"kind": "shards", "paths": paths}

    t0 = time.perf_counter()
    result = compute_gram(data, transform=args.transform,
                          chunk_rows=chunk_rows, panel=args.panel,
                          device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    # peak-memory proxy: resident f64 working set of the streamed pass vs
    # what the dense one-shot X would have needed (chunk capped at n; the
    # rank transform holds its n x w column-sweep buffer instead)
    state = p * p * 8
    resident = min(chunk_rows, result.n) * p * 8 * 2 + state
    if result.transform == "rank":
        w = max(1, min(p, RANK_BUDGET_BYTES // (result.n * 8)))
        resident = max(resident, result.n * w * 8 + state)
    dense = result.n * p * 8 + state
    meta_path = save_gram(result, args.out, extra={
        "source": src_desc,
        "chunk_rows": int(chunk_rows),
        "panel": int(args.panel),
        "wall_time_s": round(wall, 4),
        "rows_per_s": round(result.n / max(wall, 1e-9), 1),
        "peak_bytes_streamed": int(resident),
        "peak_bytes_dense": int(dense),
        "memory_ratio": round(dense / max(resident, 1), 2),
    })
    print(f"[gram prep] {result.transform} Gram of n={result.n} p={p} "
          f"({result.n_chunks} chunks of <= {chunk_rows} rows) on {dev} in "
          f"{wall:.2f}s ({result.n / max(wall, 1e-9):.0f} rows/s); "
          f"resident ~{resident / 1e6:.1f} MB vs dense "
          f"{dense / 1e6:.1f} MB ({dense / max(resident, 1):.1f}x) "
          f"-> {meta_path}")
    return meta_path


def main(argv=None, *, device=None):
    """The CLI; ``device`` (not a flag: the reference has none) picks
    where the Gram accumulates — ``None`` is the CUDA card."""
    ap = argparse.ArgumentParser(
        description="streaming Gram prep (repro_torch.data front door)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    prep = sub.add_parser("prep", help="stream a source to S.npy + meta")
    prep.add_argument("--scenario", default=None,
                      choices=available_families(),
                      help="synthesize this scenario family's stream")
    prep.add_argument("--npy", default=None,
                      help="comma-separated .npy shard paths")
    prep.add_argument("--shards", default=None,
                      help="directory of .npy / raw shards")
    prep.add_argument("--out", required=True, help="artifact directory")
    prep.add_argument("--transform", default="standardize",
                      choices=available_transforms())
    prep.add_argument("--p", type=int, default=256)
    prep.add_argument("--n", type=int, default=100_000)
    prep.add_argument("--cond", type=float, default=10.0)
    prep.add_argument("--heavy-tail-df", type=float, default=None)
    prep.add_argument("--seed", type=int, default=0)
    prep.add_argument("--chunk-rows", type=int, default=0,
                      help="rows per chunk (0 = cost-model guidance, "
                           "core.costmodel.gram_chunk_rows)")
    prep.add_argument("--panel", type=int, default=512,
                      help="column-panel edge of the blocked X^T X")

    sub.add_parser("families", help="list scenario families")

    args = ap.parse_args(argv)
    if args.cmd == "families":
        for name in available_families():
            print(name)
        return available_families()
    return _prep(args, device)


if __name__ == "__main__":
    main()
