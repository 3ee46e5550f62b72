"""omega_product_roofline.section5: the share of their roofline of the
Obs products Omega X^T (p x p by p x n): the solve's (``core/matops.py``)
and the BIC's (``estimator/report.py``), both through the matops
dispatch.  Device time: the block-sparse product (kernel 2, ``bsmm``).
Required work (``hpbench/work/omega_product.py`` at m = n): per grid
point, one product per trial, one to start the solve and one for the
BIC, at the point's final nonzeros (on a descending path the iterates
have about as many or fewer, so the count reads high, as an upper bound
would, and the share with it).  A product that the dispatch sends to
its dense branch (cuBLAS) leaves its work counted and its time out: the
share then rises, past 100% where that time was large."""
from hpbench.harness.readings import points, share
from hpbench.work import least_seconds, omega_product

UNIT = "%"
LAYER = "Omega X^T products (core/matops.py; estimator/report.py)"
MOVES = "path_s"
SOURCE = "device_trace"

KERNELS = ("bsmm",)


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    device_s, _ = tr.seconds_of(*KERNELS)
    p, n = run["config"]["p"], run["config"]["n"]
    least = sum((rep["ls_total"] + 2) * least_seconds(
        omega_product.flops(p, n, rep["nnz"]),
        omega_product.bytes_moved(p, n, rep["nnz"]), run["peaks"])
        for _, rep in points(run))
    return share(least, device_s)
