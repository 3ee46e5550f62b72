"""host_syncs_per_trial.path: the device-to-host reads the program made
in the window (every site of ``repro_torch.census``: two per sparse
line-search trial, the rest per solve, point and path) over the window's
line-search trials (the sum of ``FitReport.ls_total``)."""
from hpbench.harness.census import census
from hpbench.harness.readings import points

UNIT = "syncs"
LAYER = "prox loop (core/prox.py)"
MOVES = "path_s"
SOURCE = "program_counter"


def read(run):
    c = census(run)
    trials = sum(rep["ls_total"] for _, rep in points(run))
    if c is None or not trials or not c.syncs:
        return None
    return sum(c.syncs.values()) / trials
