"""solve_mfu.backlog: the whole solves' share of their roofline: the least
time of every request's solve (Lemma 3.4's Obs work at the iterations,
trials and nonzeros it showed, ``hpbench/work/solve.py``) at the
published peaks, over the walls of the window's fit_batch calls."""
from hpbench.harness.readings import lanes, share
from hpbench.work import solve

UNIT = "%"
LAYER = "whole solve"
MOVES = "requests_per_s"
SOURCE = "program_counter"


def read(run):
    if run["trace"] is None or not run.get("groups"):
        return None
    p, n, peaks = run["config"]["p"], run["config"]["n"], run["peaks"]
    least = sum(solve.obs_seconds(p, n, rep["iters"], rep["ls_total"],
                                  rep["nnz"], peaks)
                for _, rep in lanes(run))
    wall = sum(g["end"] - g["start"] for g in run["groups"])
    return share(least, wall)
