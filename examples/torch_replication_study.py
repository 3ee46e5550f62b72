"""Figure-3-style replication study on the PyTorch port (the port of
``examples/replication_study.py``): sweep (c_X, c_Omega) over the
processes of a torchrun group and print the measured wall time next to
the cost model's prediction (``repro_torch.core.costmodel.obs_costs`` on
the port's H100 data-sheet machine).  Uses the ``repro_torch.estimator``
facade with the distributed backend pinned per sweep point.

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      examples/torch_replication_study.py

Every process joins the group through ``repro_torch.comm.init_process_group``
(NCCL on the card: one card per process).  ``main(device="cpu")`` runs it
on the host inside the caller's gloo group, or as one process.  The data
are cast to float64, the port's contract.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch import comm
from repro_torch.core import graphs
from repro_torch.core.costmodel import H100, ProblemShape, obs_costs
from repro_torch.device import resolve_device
from repro_torch.estimator import ConcordEstimator, SolverConfig

P_DIM, N_SAMPLES = 64, 32


def candidates(P: int) -> list[tuple[int, int]]:
    """The (c_x, c_omega) pairs of powers of two whose product divides P."""
    cands, c = [], 1
    while c <= P:
        cands.append(c)
        c *= 2
    return [(cx, co) for cx in cands for co in cands
            if cx * co <= P and P % (cx * co) == 0]


def sweep(dev) -> list[dict]:
    """One warm-up and one timed Obs solve per replication pair on every
    rank of the current group; prints from rank 0 and returns the rows
    (wall time, model time, counts and the estimate)."""
    P = comm.world_size()
    say = print if P == 1 or dist.get_rank() == 0 \
        else (lambda *a, **k: None)
    prob = graphs.make_problem("chain", p=P_DIM, n=N_SAMPLES, seed=0)
    shape = ProblemShape(p=P_DIM, n=N_SAMPLES, d=3.0, s=30, t=6.0)
    x = torch.as_tensor(prob.x, dtype=torch.float64, device=dev)
    say(f"{P} processes on {dev}; p={P_DIM} n={N_SAMPLES} chain graph\n")
    say(f"{'c_x':>4} {'c_om':>4} {'measured_s':>11} {'model_s':>9}")
    rows = []
    for cx, co in candidates(P):
        est = ConcordEstimator(
            lam1=0.2, lam2=0.05,
            config=SolverConfig(backend="distributed", variant="obs",
                                c_x=cx, c_omega=co, tol=1e-5, max_iters=50,
                                device=str(dev)))
        est.fit(x)                      # warm-up
        rep = est.fit(x).report_
        model = obs_costs(shape, P, cx, co, H100).total
        rows.append({"c_x": cx, "c_omega": co, "wall_s": rep.wall_time_s,
                     "model_s": model, "iters": rep.iters,
                     "ls_total": rep.ls_total, "converged": rep.converged,
                     "omega": rep.omega})
        say(f"{cx:>4} {co:>4} {rep.wall_time_s:>11.4f} {model:>9.2e}")
    best = min(rows, key=lambda r: r["wall_s"])
    base = next(r for r in rows if r["c_x"] == 1 and r["c_omega"] == 1)
    say(f"\nbest (c_x={best['c_x']}, c_omega={best['c_omega']}): "
        f"{base['wall_s'] / best['wall_s']:.2f}x over no-replication")
    return rows


def main(argv=None, *, device=None) -> list[dict]:
    """The example; ``device`` (not a flag: the reference example has
    none) picks where it runs — ``None`` is the CUDA card.  Started by
    torchrun, it joins the group itself and leaves it at the end."""
    argparse.ArgumentParser(description=__doc__.splitlines()[0]) \
        .parse_args(argv)
    joined = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    dev = comm.init_process_group(device) if joined \
        else resolve_device(device)
    try:
        return sweep(dev)
    finally:
        if joined:
            comm.destroy_process_group()


if __name__ == "__main__":
    main()
