"""solve_mfu.path: the whole path's share of its roofline: the least time
of every solve (Lemma 3.4's Cov work at the trials and nonzeros it showed,
``hpbench/work/solve.py``) and of every point's BIC, at the published
peaks, over the measured wall of the window's paths."""
from hpbench.harness.readings import points, share
from hpbench.work import solve

UNIT = "%"
LAYER = "whole solve"
MOVES = "path_s"
SOURCE = "program_counter"


def read(run):
    if run["trace"] is None or not run.get("paths"):
        return None
    p, peaks = run["config"]["p"], run["peaks"]
    least = sum(solve.cov_seconds(p, rep["ls_total"], rep["nnz"], peaks)
                + solve.bic_seconds(p, rep["nnz"], peaks)
                for _, rep in points(run))
    wall = sum(path["end"] - path["start"] for path in run["paths"])
    return share(least, wall)
