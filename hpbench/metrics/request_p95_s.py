"""request_p95_s: the 95th percentile, over every request due in the
window, of its completion (host clock after its group's sync) minus its
due time; a request never served counts as missing (no finite value)."""
import math

from hpbench.harness.readings import percentile

UNIT = "s"
LAYER = "request queue"
SOURCE = "host_clock"


def read(run):
    reqs = run.get("requests")
    if not reqs or "paths" in run:
        return None
    return percentile([r["end"] - r["due"] if "end" in r else math.inf
                       for r in reqs], 95)
