"""group_wall_p95_s.queue: the 95th percentile of the wall of one
fit_batch call (host clock around it; it ends in a device sync)."""
from hpbench.harness.readings import percentile

UNIT = "s"
LAYER = "batched engine (core/batch.py)"
MOVES = "request_p95_s"
SOURCE = "host_clock"


def read(run):
    return percentile([g["end"] - g["start"] for g in run.get("groups")
                       or ()], 95)
