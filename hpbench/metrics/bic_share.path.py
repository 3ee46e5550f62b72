"""bic_share.path: the pseudo-likelihood BIC's share of the window's
paths: the seconds of the program's ``bic`` spans (one per path point,
``estimator/report.py:pseudo_bic``, its dense product and its three host
reads) over the sum of the paths' walls."""
from hpbench.harness.census import census

UNIT = "%"
LAYER = "pseudo-likelihood BIC (estimator/report.py)"
MOVES = "path_s"
SOURCE = "program_span"


def read(run):
    c = census(run)
    if c is None or "bic" not in c.span_s or not run.get("paths"):
        return None
    wall = sum(path["end"] - path["start"] for path in run["paths"])
    if wall <= 0:
        return None
    return 100.0 * c.span_s["bic"] / wall
