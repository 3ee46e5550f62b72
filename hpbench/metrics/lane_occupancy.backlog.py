"""lane_occupancy.backlog: the batched engine's live lanes over its padded
capacity, summed over every flat step of the window's groups
(BatchRunStats.occupancy over BatchRunStats.capacities)."""
UNIT = "%"
LAYER = "engine compaction (core/batch.py)"
MOVES = "requests_per_s"
SOURCE = "program_counter"


def read(run):
    groups = run.get("groups") or ()
    paid = sum(sum(g["capacities"]) for g in groups)
    if not paid:
        return None
    return 100.0 * sum(sum(g["occupancy"]) for g in groups) / paid
