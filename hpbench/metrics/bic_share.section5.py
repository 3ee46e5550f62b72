"""bic_share.section5: the pseudo-likelihood BIC's share of the window's
grids: the seconds of the program's ``bic`` spans (one per grid point,
``estimator/report.py:pseudo_bic``: on Obs the product Omega X^T through
the matops dispatch and one host read) over the sum of the grids'
walls."""
from hpbench.harness.census import census

UNIT = "%"
LAYER = "pseudo-likelihood BIC (estimator/report.py)"
MOVES = "path_s"
SOURCE = "program_span"


def read(run):
    c = census(run)
    if c is None or "bic" not in c.span_s or not run.get("paths"):
        return None
    wall = sum(grid["end"] - grid["start"] for grid in run["paths"])
    if wall <= 0:
        return None
    return 100.0 * c.span_s["bic"] / wall
