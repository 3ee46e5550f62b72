"""Quickstart on the PyTorch port: estimate a sparse inverse covariance
matrix with HP-CONCORD on synthetic data via the ``repro_torch.estimator``
facade (the port of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch_quickstart.py          # on the card
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      examples/torch_quickstart.py                            # distributed

Under torchrun every process joins the group through
``repro_torch.comm.init_process_group`` (NCCL on the card); the "auto"
and "distributed" backends then split the solve over the group's ranks.
``main(device="cpu")`` runs it on the host, inside a gloo group if the
caller made one.  The data are cast to float64, the port's contract.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch import comm
from repro_torch.core import graphs
from repro_torch.device import resolve_device
from repro_torch.estimator import ConcordEstimator, SolverConfig

P_DIM, N_SAMPLES = 120, 300
LAM1, LAM2 = 0.15, 0.05
PATH_GRID = [0.3, 0.25, 0.2, 0.15, 0.1]


def _config(dev, **kw) -> SolverConfig:
    return SolverConfig(tol=1e-6, max_iters=300, device=str(dev), **kw)


def run(dev) -> dict:
    """The quickstart's fits on ``dev`` in the current process group (if
    any); prints from rank 0 and returns every fitted estimator."""
    rank0 = comm.world_size() == 1 or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    prob = graphs.make_problem("chain", p=P_DIM, n=N_SAMPLES, seed=0)
    s = torch.as_tensor(prob.s, dtype=torch.float64, device=dev)
    x = torch.as_tensor(prob.x, dtype=torch.float64, device=dev)
    say(f"problem: chain graph, p={P_DIM}, n={N_SAMPLES}, "
        f"{comm.world_size()} process(es) on {dev}")
    out = {}

    def report(name, est):
        ppv, fdr = graphs.ppv_fdr(est.omega_.cpu().numpy(), prob.omega0)
        say(f"{name:<11}: {est.report_.summary()}")
        say(f"{'':<13}PPV={ppv:.3f} FDR={fdr:.3f}")

    # single-device reference backend
    ref = ConcordEstimator(
        lam1=LAM1, lam2=LAM2,
        config=_config(dev, backend="reference", variant="cov"),
    ).fit_cov(s, n_samples=N_SAMPLES)
    report("reference", ref)
    out["reference"] = ref

    # "auto" backend: engine, variant and replication chosen by the
    # paper's cost model (reference at world size 1, distributed 1.5D
    # over the process group otherwise)
    auto = ConcordEstimator(lam1=LAM1, lam2=LAM2,
                            config=_config(dev, backend="auto")).fit(x)
    report("auto", auto)
    out["auto"] = auto
    diff = float((auto.omega_ - ref.omega_).abs().max())
    say(f"max |auto - reference| = {diff:.2e}")

    # the distributed backend pinned: the 1.5D solve over every rank
    dst = ConcordEstimator(
        lam1=LAM1, lam2=LAM2,
        config=_config(dev, backend="distributed", variant="cov"),
    ).fit_cov(s, n_samples=N_SAMPLES)
    report("distributed", dst)
    out["distributed"] = dst
    diff = float((dst.omega_ - ref.omega_).abs().max())
    say(f"max |distributed - reference| = {diff:.2e}")

    # warm-started regularization path + BIC model selection in one call
    path = ConcordEstimator(
        lam2=LAM2, config=_config(dev, backend="reference", variant="cov"),
    ).fit_path(s=s, n_samples=N_SAMPLES, lam1_grid=PATH_GRID)
    best = path.best_bic()
    say(f"path       : {len(path)} fits, {path.total_iters} total iters "
        f"(warm-started); BIC-best lam1={best.lam1:g}")
    out["path"] = path

    # composable penalties (repro_torch.core.penalty): swap the prox
    # operator without touching the solver — here SCAD's unbiased tails
    scad = ConcordEstimator(
        lam1=LAM1, lam2=LAM2, penalty="scad:3.7",
        config=_config(dev, backend="reference", variant="cov"),
    ).fit_cov(s, n_samples=N_SAMPLES)
    say(f"scad       : {scad.report_.summary()}")
    out["scad"] = scad

    # two-stage adaptive-lasso refit: l1 stage-1 path, then each point
    # refit with weights 1/(|omega_hat| + eps) from its own stage-1
    # estimate (weighted_l1 specs under the hood)
    apath = ConcordEstimator(
        lam2=LAM2, config=_config(dev, backend="reference", variant="cov"),
    ).fit_path(s=s, n_samples=N_SAMPLES, lam1_grid=PATH_GRID, adaptive=True)
    abest = apath.best_bic()
    ppv, fdr = graphs.ppv_fdr(abest.omega.cpu().numpy(), prob.omega0)
    ppv1, fdr1 = graphs.ppv_fdr(apath.stage1.best_bic().omega.cpu().numpy(),
                                prob.omega0)
    say(f"adaptive   : 2-stage refit, BIC-best lam1={abest.lam1:g}; "
        f"PPV {ppv1:.3f}->{ppv:.3f}, FDR {fdr1:.3f}->{fdr:.3f}")
    out["adaptive"] = apath
    return out


def main(argv=None, *, device=None) -> dict:
    """The example; ``device`` (not a flag: the reference example has
    none) picks where it runs — ``None`` is the CUDA card.  Started by
    torchrun, it joins the group itself and leaves it at the end."""
    argparse.ArgumentParser(description=__doc__.splitlines()[0]) \
        .parse_args(argv)
    joined = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    dev = comm.init_process_group(device) if joined \
        else resolve_device(device)
    try:
        return run(dev)
    finally:
        if joined:
            comm.destroy_process_group()


if __name__ == "__main__":
    main()
