"""prox_roofline.path: the fused prox's (kernel 1) share of its roofline:
its launches in the trace times the work one launch needs
(``hpbench/work/prox.py``) at the published peaks, over its device time."""
from hpbench.harness.readings import share
from hpbench.work import least_seconds, prox

UNIT = "%"
LAYER = "fused prox (kernels/softthresh.py, kernel 1)"
MOVES = "path_s"
SOURCE = "device_trace"

KERNELS = ("fused_prox_stats",)


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    device_s, launches = tr.seconds_of(*KERNELS)
    p = run["config"]["p"]
    one = least_seconds(prox.flops(p), prox.bytes_moved(p), run["peaks"])
    return share(launches * one, device_s)
