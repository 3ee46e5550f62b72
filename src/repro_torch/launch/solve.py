"""HP-CONCORD launcher: sparse inverse covariance estimation through the
``repro_torch.estimator`` facade, on one CUDA card.  Port of
``repro.launch.solve``, with the same flags:

  PYTHONPATH=src python -m repro_torch.launch.solve --graph chain \\
      --p 200 --n 400 --lam1 0.15 --backend auto

The cost model (paper Lemmas 3.1-3.5, the port's H100 constants) prints
its choice of variant and replication factors for P processes: the
process group's world size, 1 outside one.  Started under torchrun the
CLI joins the group itself (NCCL on the card), one rank per process, and
``--backend distributed`` (or ``auto`` at P > 1) solves on the 1.5D grid
of the ranks, with ``--cx`` / ``--comega`` pinning the replication:

  torchrun --nproc-per-node 1 -m repro_torch.launch.solve \
      --from-gram build/gram_art --lam1 0.3 --backend distributed

Only rank 0 prints.  ``--path`` runs a lam1 path and reports the
BIC-best point; ``--path-mode batched`` runs the grid in lock step;
``--penalty`` swaps the prox operator; ``--sparse-matmul on`` routes the
Omega-side product through the block-sparse kernel.

``--from-gram DIR`` solves straight from a ``launch.gram prep`` artifact
(S.npy + metadata, written by either package) — the raw observations
never enter this process:

  PYTHONPATH=src python -m repro_torch.launch.solve --from-gram \\
      results/gram_sf --lam1 0.15

``main(argv, device="cpu")`` solves on the host, inside a gloo group
when the caller has joined one.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from ..comm import group
from ..core import graphs
from ..core.costmodel import H100, ProblemShape, tune
from ..device import resolve_device
from ..estimator import ConcordEstimator, SolverConfig
from ..estimator.backends import NNZ_TOL, estimate_density


def _log(*args) -> None:
    """Print on rank 0 only."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*args)


def _avg_degree(omega: torch.Tensor) -> float:
    """``graphs.avg_degree`` on the estimate's device."""
    edges = int(torch.triu(omega.abs() > NNZ_TOL, diagonal=1).sum())
    return 2.0 * edges / omega.shape[0]


def _config(args, device, variant: str) -> SolverConfig:
    return SolverConfig(
        backend=args.backend, variant=variant,
        c_x=args.cx, c_omega=args.comega,
        tol=args.tol, max_iters=args.max_iters,
        sparse_matmul=args.sparse_matmul, sparse_block=args.sparse_block,
        sparse_threshold=args.sparse_threshold, penalty=args.penalty,
        device=device)


def _fit(est, args, **data):
    """A single fit, or the ``--path`` sweep and its BIC choice."""
    if not args.path:
        if "gram" in data:
            return est.fit_gram(data["gram"]).report_
        return est.fit(data["x"]).report_
    grid = [float(v) for v in args.path.split(",")]
    if "gram" in data:
        gram = data["gram"]
        path = est.fit_path(s=gram.s, n_samples=gram.n, lam1_grid=grid,
                            mode=args.path_mode, adaptive=args.adaptive)
    else:
        path = est.fit_path(data["x"], lam1_grid=grid, mode=args.path_mode,
                            adaptive=args.adaptive)
    _log(path.summary())
    chosen = path.best_bic()
    _log(f"BIC-best lam1={chosen.lam1:g} (bic={chosen.bic:.1f})")
    return chosen


def _solve_from_gram(args, config):
    """Solve from a prepped Gram artifact: the raw data never loads."""
    from .gram import load_gram

    gram = load_gram(args.from_gram, device=config.device)
    est = ConcordEstimator(lam1=args.lam1, lam2=args.lam2, config=config)
    _log(f"[gram] {gram.transform} Gram: n={gram.n} p={gram.p} "
         f"({gram.n_chunks} chunks, source dtype {gram.source_dtype})")
    rep = _fit(est, args, gram=gram)
    _log(rep.summary())
    _log(f"avg degree {_avg_degree(rep.omega):.2f}")
    return rep


def main(argv=None, *, device=None):
    """The CLI; ``device`` (not a flag: the reference has none) picks
    where the solve runs — ``None`` is the CUDA card."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="chain", choices=["chain", "random"])
    ap.add_argument("--p", type=int, default=200)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--lam1", type=float, default=0.15)
    ap.add_argument("--lam2", type=float, default=0.05)
    ap.add_argument("--penalty", default="l1", metavar="KIND",
                    help="penalty family (core.penalty string form): l1, "
                         "elastic_net, scad[:A], mcp[:GAMMA]; strength "
                         "comes from --lam1/--lam2")
    ap.add_argument("--adaptive", action="store_true",
                    help="two-stage adaptive-lasso refit of --path: "
                         "stage-1 l1 path, then each grid point refit "
                         "with weights 1/(|omega|+eps) built from its "
                         "own stage-1 estimate (pointwise)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "reference", "distributed"])
    ap.add_argument("--variant", default="auto",
                    choices=["auto", "cov", "obs"])
    ap.add_argument("--cx", type=int, default=None)
    ap.add_argument("--comega", type=int, default=None)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--max-iters", type=int, default=300)
    ap.add_argument("--sparse-matmul", default="off",
                    choices=["off", "on", "auto"],
                    help="route Ω-side products through the block-sparse "
                         "matops layer once the observed iterate block "
                         "density crosses the threshold ('auto' takes the "
                         "threshold from the cost model crossover)")
    ap.add_argument("--sparse-block", type=int, default=128,
                    help="occupancy-mask tile edge for --sparse-matmul")
    ap.add_argument("--sparse-threshold", type=float, default=None,
                    help="block-density crossover override in (0, 1]")
    ap.add_argument("--path", default=None, metavar="LAM1S",
                    help="comma-separated lam1 grid: run a "
                         "regularization path instead of a single fit")
    ap.add_argument("--path-mode", default="sequential",
                    choices=["sequential", "batched"],
                    help="sequential: one warm-started solve per path "
                         "point; batched: the whole grid in lock step "
                         "(core.batch)")
    ap.add_argument("--from-gram", default=None, metavar="DIR",
                    help="solve from a launch.gram prep artifact "
                         "(S.npy + gram_meta.json) instead of "
                         "synthesizing a problem")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.adaptive and not args.path:
        ap.error("--adaptive needs --path (it refits a lam1 grid)")
    resolve_device(device)
    config = _config(args, device, "cov" if args.from_gram else args.variant)
    joined = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if joined:
        group.init_process_group(device)
    try:
        return _main(args, config)
    finally:
        if joined:
            group.destroy_process_group()


def _main(args, config):
    if args.from_gram:
        return _solve_from_gram(args, config)

    prob = graphs.make_problem(args.graph, args.p, args.n, seed=args.seed)
    P = group.world_size()
    shape = ProblemShape(p=args.p, n=args.n,
                         d=estimate_density(args.p, args.n, args.lam1))
    best = tune(shape, P, H100)
    _log(f"[costmodel] P={P}: best variant={best.variant} "
         f"c_x={best.c_x} c_omega={best.c_omega} "
         f"T_model={best.total:.3e}s "
         f"(compute {best.t_compute:.2e} / latency {best.t_latency:.2e} "
         f"/ bandwidth {best.t_bandwidth:.2e})")

    est = ConcordEstimator(lam1=args.lam1, lam2=args.lam2, config=config)
    rep = _fit(est, args, x=prob.x)
    est_omega = rep.omega.cpu().numpy()
    ppv, fdr = graphs.ppv_fdr(est_omega, prob.omega0)
    _log(rep.summary())
    _log(f"PPV {ppv:.3f}  FDR {fdr:.3f}  "
         f"avg degree {graphs.avg_degree(est_omega):.2f}")
    return rep


if __name__ == "__main__":
    main()
