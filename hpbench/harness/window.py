"""What every driver of a measured window shares.

A mix's ``driver`` (``hpbench/drivers/<driver>.py``, found by name) is a
class ``Driver(config, traffic, seed, device)`` with:

* ``make_inputs(seconds)``: the run's inputs, made from the seed on the
  device (set-up);
* ``warm()``: the window's calls once, on the cell's own shapes (set-up);
* ``window(seconds)``: the measured window under ``WINDOW_RANGE``; it
  returns what the metric readers read (``paths`` or ``groups`` and
  ``requests``, ``failed``, ``window_s``) and ``kept``, the estimates
  the check compares;
* ``checked(run)`` / ``planned()``: the items the check compares, with
  and without the program's answers; each names its ``dataset`` (an
  index into ``x``), its ``lam2``, and a path's ``grid`` or a single
  solve's ``lam1``;
* ``x``: every data set the run made, (count, n, p), which the
  reference reads, and ``device``;
* ``release()``: drops what the program holds before the check.

The CONCORD variant is the configuration's ``variant``: the program is
handed S (Cov) or X (Obs), and the check solves the same variant.
"""
from __future__ import annotations

import time

import torch

from ..reference import concord

#: seconds past the close within which a due request must be served
DRAIN_S = 60.0

#: what the program is handed for one data set X (n x p), by variant
PROGRAM_INPUT = {"cov": "s", "obs": "x"}


def clock() -> float:
    return time.perf_counter()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def solver_config(config: dict, device: str):
    from repro_torch.estimator import SolverConfig
    if config["solver"]["variant"] != config["variant"]:
        raise ValueError("the solver's variant is not the configuration's")
    return SolverConfig(**config["solver"], device=device)


def program_input(config: dict) -> str:
    """The keyword (``s`` or ``x``) the program takes its data under."""
    try:
        return PROGRAM_INPUT[config["variant"]]
    except KeyError:
        raise ValueError(f"unknown variant {config['variant']!r}") from None


def program_data(config: dict, x: torch.Tensor) -> torch.Tensor:
    """What the program is handed for data sets ``x`` ((count, n, p)):
    X itself (Obs), or each set's S = X^T X / n (Cov), stacked."""
    if program_input(config) == "x":
        return x
    p = x.shape[-1]
    out = torch.empty((x.shape[0], p, p), dtype=x.dtype, device=x.device)
    for k in range(x.shape[0]):
        out[k] = concord.sample_covariance(x[k])
    return out


def report_row(rep) -> dict:
    nnz = rep.nnz_per_row * rep.omega.shape[0]
    return {"lam1": rep.lam1, "lam2": rep.lam2, "iters": rep.iters,
            "ls_total": rep.ls_total, "converged": rep.converged,
            "stalled": rep.stalled, "wall_s": rep.wall_time_s, "nnz": nnz,
            "bic": rep.bic}
