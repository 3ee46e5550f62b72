"""host_ms_per_flat_step.backlog: the batched engine's host time per flat
step (one line-search trial of every live lane): the seconds of the
program's ``batch.flat_step`` spans less those blocked in the step's own
host sync, over the flat steps: the host's launches of the step and
its work after the sync, when the device queue is empty."""
from hpbench.harness.census import host_ms_per_flat_step

UNIT = "ms"
LAYER = "batched engine (core/batch.py)"
MOVES = "requests_per_s"
SOURCE = "program_span"


def read(run):
    return host_ms_per_flat_step(run)
