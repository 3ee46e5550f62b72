"""Readings the benchmark's bounds and limits are set from (not a run).

    python3 hpbench/calibrate.py sweep --workload cortex-p4096.queue \\
        --rates 8,10,12 --seconds 30 --seed 11
    python3 hpbench/calibrate.py limits --workload chain-p16384.path \\
        --seeds 1,2,3 --seconds 6 --control-seeds 1,2,3

``sweep`` serves the queue mix at each rate (one process, the cell's
sizes) and prints, per rate, the 95th-percentile latency, the queue
wait in the first and the last third of the window and the drain after
the close: a backlog that grows shows as a wait that climbs across the
window and a drain that lasts.  ``--config`` / ``--traffic`` (JSON)
replace entries of the configuration and the mix, to read another size:

    python3 hpbench/calibrate.py sweep --workload cortex-p4096.backlog \
        --rates 0 --seconds 20 --traffic '{"pool": 64}' \
        --config '{"p": 8192, "graph": {"cols": 128}}'

``limits`` runs the cell (short windows, the cell's sizes and load) on
each seed and prints the numbers its check compares (the program's
readings), then, on each control seed, the same comparison with the
reference in float32 (TF32 off) put in the program's place: the
control's readings.  Each reading is one JSON line on standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hpbench.harness import cell, check, manifest  # noqa: E402


def _mix(workload: str, seed: int, device: str, config_extra=None,
         traffic_extra=None):
    man = manifest.manifest(ROOT)
    c = manifest.cell(man, workload)
    config = cell._merge(manifest.config(man, c["config"], ROOT),
                         config_extra)
    traffic = cell._merge(manifest.traffic(c["traffic"], ROOT),
                          traffic_extra)
    drv = manifest.driver(traffic, ROOT)(config, traffic, seed, device)
    return drv, config, traffic


def sweep(args) -> None:
    for rate in (float(r) for r in args.rates.split(",")):
        extra = {**json.loads(args.traffic), "rate_per_s": rate}
        drv, _, _ = _mix(args.workload, args.seed, args.device,
                         json.loads(args.config), extra)
        t0 = time.perf_counter()
        drv.setup(args.seconds)
        setup_s = time.perf_counter() - t0
        run = drv.window(args.seconds)
        reqs = run["requests"]
        walls = [g["end"] - g["start"] for g in run["groups"]]
        lat = [r["end"] - r["due"] for r in reqs if "end" in r]
        third = args.seconds / 3
        first = [r["start"] - r["due"] for r in reqs
                 if "start" in r and r["due"] < third]
        last = [r["start"] - r["due"] for r in reqs
                if "start" in r and r["due"] >= 2 * third]
        print(json.dumps({
            "rate_per_s": rate, "due": len(reqs), "served": len(lat),
            "p50_s": float(np.percentile(lat, 50)),
            "p95_s": float(np.percentile(lat, 95)),
            "wait_first_third_s": float(np.mean(first)),
            "wait_last_third_s": float(np.mean(last)),
            "drain_after_close_s": run["window_s"] - args.seconds,
            "groups": len(run["groups"]),
            "served_per_s": len(lat) / run["window_s"],
            "group_wall_p50_s": float(np.percentile(walls, 50)),
            "setup_s": setup_s,
            "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                  if args.device == "cuda" else 0),
            "mean_group": len(lat) / max(1, len(run["groups"]))}),
            flush=True)
        drv.release()
        del drv, run


def _control(workload: str, seed: int, seconds: float, device: str) -> dict:
    drv, config, _ = _mix(workload, seed, device)
    drv.setup(seconds)
    items = drv.planned()
    t0 = time.perf_counter()
    refs = check.reference(drv, items, config)
    t_ref = time.perf_counter() - t0
    ctrl = check.reference(drv, items, config, dtype=torch.float32)
    return {"workload": workload, "seed": seed, "side": "control",
            "reference_s": t_ref, **check.gaps(ctrl, refs)}


def limits(args) -> None:
    for seed in (int(s) for s in args.seeds.split(",") if s):
        res = cell.run_cell(args.workload, seed, args.seconds, False,
                            device=args.device, root=ROOT)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "program", "correct": res["correct"],
                          **{k: v["value"] for k, v in
                             res["checks"].items()},
                          "metrics": res["metrics"]}), flush=True)
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        print(json.dumps(_control(args.workload, seed, args.seconds,
                                  args.device)), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sw = sub.add_parser("sweep")
    sw.add_argument("--rates", required=True)
    sw.add_argument("--seed", type=int, default=1)
    sw.add_argument("--config", default="{}")
    sw.add_argument("--traffic", default="{}")
    lm = sub.add_parser("limits")
    lm.add_argument("--seeds", default="")
    lm.add_argument("--control-seeds", default="")
    for p in (sw, lm):
        p.add_argument("--workload", required=True)
        p.add_argument("--seconds", type=float, required=True)
        p.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    {"sweep": sweep, "limits": limits}[args.cmd](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
