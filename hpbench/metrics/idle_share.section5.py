"""The share of the traced window in which nothing ran on the device:
one minus the union of the device's kernel, copy and set intervals over
the window (torch.profiler)."""
from hpbench.harness.readings import idle_percent

UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "path_s"


def read(run):
    return idle_percent(run)
