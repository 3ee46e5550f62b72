"""queue_wait_p95_s.queue: the 95th percentile, over the window's served
requests, of the wait from the request's due time to the start of the
fit_batch call that solved it (the harness's FIFO grouping)."""
from hpbench.harness.readings import percentile

UNIT = "s"
LAYER = "request queue (FIFO groups ahead of estimator/batch.py)"
MOVES = "request_p95_s"
SOURCE = "host_clock"


def read(run):
    return percentile([r["start"] - r["due"] for r in run.get("requests")
                       or () if "start" in r], 95)
