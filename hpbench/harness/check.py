"""The comparison that decides ``correct``.

What the timed path produced (the estimates the window's own calls
returned, for the seed's sample of paths or requests) is held against the
plain reference (``hpbench.reference.concord``), run after the window on
the same inputs the benchmark made.  The reference takes nothing from the
program: it solves the configuration's variant (Cov on S formed again
from the benchmark's X, or Obs on X) from the identity (a path's later
points from its own previous estimate).

Numbers compared, each against its limit in the cell's file
(``hpbench/limits/<cell>.json``; a number with none stops the run):

* ``omega_gap``: the largest max |Omega_program - Omega_reference| over
  max |Omega_reference| among the compared estimates;
* ``bic_gap`` (paths): the largest |BIC_program - BIC_reference| over
  |BIC_reference| among the compared path points.

``reference(...)`` in float32 (TF32 off) stands in for the program to
read the control (``hpbench/calibrate.py``).
"""
from __future__ import annotations

import math

import torch

from ..reference import concord


def _dense(t: torch.Tensor) -> torch.Tensor:
    return t.to_dense() if t.is_sparse else t


def _gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    a = _dense(a).to(torch.float64)
    ref = _dense(ref).to(torch.float64)
    g = float((a - ref).abs().max() / ref.abs().max())
    return math.inf if math.isnan(g) else g


def _rel(a: float, ref: float) -> float:
    if a == ref:
        return 0.0
    if not (math.isfinite(a) and math.isfinite(ref)):
        return math.inf
    return abs(a - ref) / max(abs(ref), 1e-300)


def problem(config: dict, x: torch.Tensor, lam2: float):
    """The reference's problem of the configuration's variant on data set
    ``x`` (n x p): Cov on S formed again from X, or Obs on X."""
    variant = config["variant"]
    if variant == "cov":
        return concord.CovProblem(concord.sample_covariance(x), lam2)
    if variant == "obs":
        return concord.ObsProblem(x, lam2)
    raise ValueError(f"unknown variant {variant!r}")


def reference(driver, items: list[dict], config: dict,
              dtype=torch.float64) -> list[dict]:
    """The reference's answers for ``items`` (``driver.checked(run)`` or
    ``driver.planned()``), computed in ``dtype`` on the data sets the
    driver made (``driver.x``): a path warm from its own estimates, with
    the BIC on S formed from X; a single solve from the identity."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sol = config["solver"]
    kw = dict(tol=sol["tol"], max_iters=sol["max_iters"],
              max_ls=sol["max_ls"])
    out = []
    for item in items:
        x = driver.x[item["dataset"]].to(driver.device, dtype)
        prob = problem(config, x, item["lam2"])
        if "grid" in item:
            s = prob.s if isinstance(prob, concord.CovProblem) else \
                concord.sample_covariance(x)
            omegas, bics, prev = [], [], None
            for lam1 in sorted(item["grid"], reverse=True):
                res = concord.solve(prob, lam1, prev, **kw)
                prev = res.omega
                omegas.append(res.omega.to_sparse())
                bics.append(concord.pseudo_bic(res.omega, s, config["n"]))
            del s, prev
            out.append({"omegas": omegas, "bics": bics})
        else:
            res = concord.solve(prob, item["lam1"], None, **kw)
            out.append({"omega": res.omega.to_sparse()})
            del res
        del x, prob
    return out


def gaps(items: list[dict], refs: list[dict]) -> dict:
    """The compared numbers of ``items`` against ``refs``."""
    omega, bic = 0.0, None
    for item, ref in zip(items, refs):
        if "omegas" in item:
            for a, r in zip(item["omegas"], ref["omegas"]):
                omega = max(omega, _gap(a, r))
            for a, r in zip(item["bics"], ref["bics"]):
                bic = max(bic or 0.0, _rel(a, r))
        else:
            omega = max(omega, _gap(item["omega"], ref["omega"]))
    out = {"omega_gap": omega}
    if bic is not None:
        out["bic_gap"] = bic
    return out


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit, and whether all are within."""
    missing = sorted(set(values) - set(limits))
    if missing:
        raise KeyError(f"no limit for {', '.join(missing)}: read one "
                       "(hpbench/calibrate.py limits) and state it")
    shown = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    ok = all(v <= limits[k] for k, v in values.items())
    return ok, shown
