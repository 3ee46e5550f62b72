"""ms_per_flat_step.backlog: the batched engine's time per flat step (one
line-search trial of every live lane): the walls of the window's
fit_batch calls over their flat steps (BatchRunStats.capacities)."""
UNIT = "ms"
LAYER = "batched engine (core/batch.py)"
MOVES = "requests_per_s"
SOURCE = "program_counter"


def read(run):
    groups = run.get("groups") or ()
    steps = sum(len(g["capacities"]) for g in groups)
    if not steps:
        return None
    return 1e3 * sum(g["end"] - g["start"] for g in groups) / steps
