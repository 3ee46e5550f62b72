"""trials_per_path.path: line-search trials per path (FitReport.ls_total
summed over a path's points, averaged over the window's paths)."""
from hpbench.harness.readings import points

UNIT = "trials"
LAYER = "line search (core/prox.py)"
MOVES = "path_s"
SOURCE = "program_counter"


def read(run):
    paths = run.get("paths")
    if not paths:
        return None
    return sum(rep["ls_total"] for _, rep in points(run)) / len(paths)
