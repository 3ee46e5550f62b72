"""Inputs made from the run's seed: ground-truth graphs, samples, requests.

Everything a cell needs is drawn here, on the run's device, from
``--seed`` alone: the same seed gives the same inputs.  The ground truth
is the configuration's graph (``hpbench/graphs/<kind>.py``, found by
name).

A mix with a ``schedule_seed`` draws its arrivals and its requests'
parameters from that seed alone: every run then meets one schedule,
and the run's seed draws the data (and the check's sample).  The
open-loop queue takes it, since the order of arrivals and of work moves
a tail more than two runs of one seed differ.  Its draws are plain:
Poisson arrivals (exponential gaps), lam1 uniform, lam2 uniform over
its values.

Where the run's seed draws the requests (a path's grids, a backlog),
two seeds give the same SET of sizes in a different order, so the seed
changes which work comes when, not how much work a window holds: lam1
values are stratified (each block of ``block`` requests, or path points
of one rank, takes one value from each of ``block`` equal strata of the
range, in a seeded order, with a seeded offset inside its stratum), and
lam2 values repeat evenly in a seeded order.  Subjects are a seeded
permutation of the pool, pass after pass, in every mix.
"""
from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one stream of the run, from the run's seed."""
    ss = np.random.SeedSequence(entropy=int(seed) % 2**64,
                                spawn_key=tuple(int(k) for k in keys))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *keys))


def device_generator(device, seed: int, *keys: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *keys))
    return gen


# ---------------------------------------------------------------------------
# ground truth and samples
# ---------------------------------------------------------------------------

def ground_truth(graph: dict, p: int, device) -> torch.Tensor:
    """Omega0 (p x p, float64) of the configuration's ``graph``."""
    from . import manifest
    return manifest.graph(graph["kind"]).omega(graph, p, device)


def sample_gaussian(chol: torch.Tensor, rows: int,
                    gen: torch.Generator) -> torch.Tensor:
    """(rows, p) draws of N(0, inv(omega0)) given omega0 = L L^T as
    ``chol`` = L: X = Z inv(L)^T, on L's device."""
    z = torch.randn((chol.shape[0], rows), generator=gen, dtype=chol.dtype,
                    device=chol.device)
    x = torch.linalg.solve_triangular(chol.T, z, upper=True)
    del z
    return x.T.contiguous()


def datasets(config: dict, count: int, seed: int, device) -> torch.Tensor:
    """``count`` data sets of ``config["n"]`` rows each, (count, n, p),
    from one ground truth; data set k is drawn from its own stream."""
    p, n = config["p"], config["n"]
    chol = torch.linalg.cholesky(ground_truth(config["graph"], p, device))
    out = torch.empty((count, n, p), dtype=torch.float64, device=device)
    for k in range(count):
        out[k] = sample_gaussian(chol, n, device_generator(device, seed, 1, k))
    return out


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

def stratified(lo: float, hi: float, count: int, block: int,
               gen: np.random.Generator) -> np.ndarray:
    """``count`` values in [lo, hi): every block of ``block`` takes one
    value from each of ``block`` equal strata, in a seeded order."""
    out = np.empty(count)
    for start in range(0, count, block):
        m = min(block, count - start)
        strata = gen.permutation(block)[:m]
        out[start:start + m] = lo + (hi - lo) * (strata + gen.random(m)) / block
    return out


def path_grids(traffic: dict, count: int, seed: int) -> list[list[float]]:
    """``count`` descending lam1 grids: point j of every path comes from
    the j-th of ``points`` equal slices of the range, high to low."""
    lo, hi = traffic["lam1_range"]
    pts = traffic["points"]
    gen = rng(seed, 2)
    width = (hi - lo) / pts
    cols = [stratified(hi - (j + 1) * width, hi - j * width, count,
                       traffic["block"], gen) for j in range(pts)]
    return [[float(cols[j][k]) for j in range(pts)] for k in range(count)]


def solve_requests(traffic: dict, count: int, seed: int) -> dict:
    """``count`` single-subject requests: subject, lam1, lam2, drawn from
    the mix's ``schedule_seed`` where it has one (plain draws), else from
    the run's (stratified)."""
    fixed = "schedule_seed" in traffic
    gen = rng(traffic["schedule_seed"] if fixed else seed, 3)
    pool = traffic["pool"]
    lo, hi = traffic["lam1_range"]
    lam2_values = np.asarray(traffic["lam2_values"], dtype=np.float64)
    subjects = np.concatenate([gen.permutation(pool)
                               for _ in range(-(-count // pool))])[:count]
    if fixed:
        lam1 = gen.uniform(lo, hi, count)
        lam2 = gen.choice(lam2_values, count)
    else:
        block = traffic["block"]
        lam1 = stratified(lo, hi, count, block, gen)
        lam2 = np.concatenate([
            gen.permutation(np.resize(lam2_values, block))
            for _ in range(-(-count // block))])[:count]
    return {"subject": subjects.astype(np.int64), "lam1": lam1,
            "lam2": lam2}


#: exponential gaps are drawn this many at a time, so a longer window's
#: schedule begins with a shorter one's
GAP_CHUNK = 256


def arrivals(traffic: dict, seconds: float, seed: int) -> np.ndarray:
    """Due times in [0, seconds): all at 0 for a backlog of
    ``traffic["requests"]``, else a Poisson process at ``rate_per_s``
    (exponential gaps), drawn from the mix's ``schedule_seed`` where it
    has one, else from the run's."""
    if traffic["arrivals"] == "backlog":
        return np.zeros(traffic["requests"])
    if traffic["arrivals"] != "poisson":
        raise ValueError(f"unknown arrivals {traffic['arrivals']!r}")
    gen = rng(traffic.get("schedule_seed", seed), 4)
    scale = 1.0 / traffic["rate_per_s"]
    due, last = [], 0.0
    while last < seconds:
        chunk = last + np.cumsum(gen.exponential(scale, GAP_CHUNK))
        due.append(chunk)
        last = float(chunk[-1])
    due = np.concatenate(due)
    return due[due < seconds]
