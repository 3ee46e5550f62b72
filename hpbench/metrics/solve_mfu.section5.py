"""solve_mfu.section5: the whole grid's share of its roofline: the least
time of every solve (Lemma 3.4's Obs work at the iterations, trials and
nonzeros it showed, ``hpbench/work/solve.py``) and of every point's Obs
BIC (one product Omega X^T, ``hpbench/work/omega_product.py`` at m = n),
at the published peaks, over the measured wall of the window's grids."""
from hpbench.harness.readings import points, share
from hpbench.work import least_seconds, omega_product, solve

UNIT = "%"
LAYER = "whole solve"
MOVES = "path_s"
SOURCE = "program_counter"


def read(run):
    if run["trace"] is None or not run.get("paths"):
        return None
    p, n, peaks = run["config"]["p"], run["config"]["n"], run["peaks"]
    least = sum(solve.obs_seconds(p, n, rep["iters"], rep["ls_total"],
                                  rep["nnz"], peaks)
                + least_seconds(omega_product.flops(p, n, rep["nnz"]),
                                omega_product.bytes_moved(p, n, rep["nnz"]),
                                peaks)
                for _, rep in points(run))
    wall = sum(grid["end"] - grid["start"] for grid in run["paths"])
    return share(least, wall)
