"""ms_per_trial.path: the prox loop's time per line-search trial: the
sum of FitReport.wall_time_s over the window's path points over the sum
of their line-search trials (FitReport.ls_total)."""
from hpbench.harness.readings import points

UNIT = "ms"
LAYER = "prox loop (core/prox.py)"
MOVES = "path_s"
SOURCE = "program_counter"


def read(run):
    rows = [rep for _, rep in points(run)]
    trials = sum(r["ls_total"] for r in rows)
    if not trials:
        return None
    return 1e3 * sum(r["wall_s"] for r in rows) / trials
