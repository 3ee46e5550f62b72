"""One run of one cell: set-up, the measured window, the check, the line.

``run_cell`` is the whole run short of the command line's look for a
chip, so tests drive it on the CPU at small sizes (``overrides``) with
the program broken underneath.
"""
from __future__ import annotations

import copy
import gc
import subprocess
import time

import torch

from . import check, manifest, trace, window
from .peaks import peaks_for


def _merge(base: dict, extra: dict | None) -> dict:
    out = copy.deepcopy(base)
    for k, v in (extra or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def power_limit_w() -> float | None:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_info(device: str) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
            "power_limit_w": power_limit_w()}


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", t_start: float | None = None,
             overrides: dict | None = None, root=manifest.ROOT) -> dict:
    """Run ``workload`` once; returns the result line's object with the
    checked numbers under ``checks``.  ``overrides`` replaces entries of
    the configuration (``"config"``) and the mix (``"traffic"``), and
    ``"cell"`` the cell's own entries (which configuration, which mix)."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest.manifest(root)
    overrides = overrides or {}
    cell = {**manifest.cell(man, workload), **overrides.get("cell", {})}
    config = _merge(manifest.config(man, cell["config"], root),
                    overrides.get("config"))
    traffic = _merge(manifest.traffic(cell["traffic"], root),
                     overrides.get("traffic"))
    limits = manifest.limits(workload, root)
    entries = manifest.metrics_for(man, workload, traced)
    readers = {m["name"]: manifest.metric_module(m["name"], root)
               for m in entries}

    # set-up, in parts (reported beside setup_s, for its spread)
    marks = [("imports_s", time.perf_counter())]
    mix = manifest.driver(traffic, root)(config, traffic, seed, device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window.sync(device)
    marks.append(("program_and_device_s", time.perf_counter()))
    mix.make_inputs(seconds)
    window.sync(device)
    marks.append(("inputs_s", time.perf_counter()))
    mix.warm()
    window.sync(device)
    marks.append(("warmup_s", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    parts, prev = {}, t_start
    for name, t in marks:
        parts[name], prev = t - prev, t

    from repro_torch.kernels import ops
    ops.reset_launches()
    with trace.profiled(traced, torch.device(device).type) as prof:
        run = mix.window(seconds)
    launches = dict(ops.LAUNCHES)
    dev = device_info(device)
    summary = trace.summarize(prof) if traced else None

    record = {"config": config, "traffic": traffic, "seconds": seconds,
              "setup_s": setup_s, "launches": launches,
              "peaks": peaks_for(dev["kind"]), "trace": summary, **run}
    metrics = {}
    for m in entries:
        value = readers[m["name"]].read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check, once the window has closed and the peak has been read
    items = mix.checked(run)
    mix.release()
    del run
    gc.collect()
    refs = check.reference(mix, items, config)
    ok, shown = check.verdict(check.gaps(items, refs), limits)
    failed = run_failed(record)
    result = {"correct": ok and failed == 0,
              "attempted": attempted(record), "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s,
                                window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
    result["setup_parts"] = parts
    result["checks"] = shown
    return result


def attempted(record: dict) -> int:
    if "paths" in record:
        return len(record["paths"])
    return len(record["requests"])


def run_failed(record: dict) -> int:
    """Requests due in the window that were never served (a path, or a
    request, whose call raised ends the run instead)."""
    return record.get("failed", 0)
