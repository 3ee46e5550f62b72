"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 hpbench/run.py --workload chain-p16384.path --seed 7 \\
        --seconds 40 --trace 0

from the root of a checkout, on a machine with the cell's chips.  The
last line of standard output is the run's result (one JSON object); the
numbers the check compared, each beside its limit, end standard error.
With ``--trace 1`` the window runs under the profiler and the line holds
the cell's per-layer metrics instead of its end-to-end ones.

The program under test is ``repro_torch`` from ``src/`` of the checkout;
its kernels build into ``build/repro_torch_kernels`` there on first use.
The run exits non-zero and prints no result without a CUDA card (or with
fewer than the cell asks for), and if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; the program on the
    path; no library that would load JAX by itself."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from hpbench.harness import cell, guard, manifest

    if not torch.cuda.is_available():
        print("hpbench: no CUDA card; the benchmark runs only on one",
              file=sys.stderr)
        return 2
    need = manifest.cell(manifest.manifest(ROOT), args.workload)["chips"]
    if torch.cuda.device_count() < need:
        print(f"hpbench: {args.workload} needs {need} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = cell.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda",
                           t_start=T_START, root=ROOT)
    found = guard.forbidden_modules()
    if found:
        print(f"hpbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
