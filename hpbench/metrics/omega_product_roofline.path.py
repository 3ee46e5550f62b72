"""omega_product_roofline.path: the share of their roofline of the
products with Omega: the solve's (``core/matops.py``) and the BIC's
(``estimator/report.py``).  Device time: the block-sparse product (kernel
2, ``bsmm``) and the dense f64 GEMMs (cuBLAS: the dense branch of the
matops dispatch and the BIC's product, which the trace cannot tell
apart by name).  Required work (``hpbench/work/omega_product.py``): per
path point, one product per trial, one to start the solve and one for
the BIC, each Omega (p x p) times S (p x p), at the point's final
nonzeros.  On a descending path the iterates have about as many
nonzeros as the point's end, or fewer, so the count reads high, as an
upper bound would, and the share with it.  A product that moves to a
kernel named neither way leaves its work counted and its time out: the
share then rises, past 100% where that time was large."""
from hpbench.harness.readings import points, share
from hpbench.work import least_seconds, omega_product

UNIT = "%"
LAYER = ("Omega-side products and the BIC's product "
         "(core/matops.py; estimator/report.py)")
MOVES = "path_s"
SOURCE = "device_trace"

KERNELS = ("bsmm", "gemm")


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    device_s, _ = tr.seconds_of(*KERNELS)
    p = run["config"]["p"]
    least = sum((rep["ls_total"] + 2) * least_seconds(
        omega_product.flops(p, p, rep["nnz"]),
        omega_product.bytes_moved(p, p, rep["nnz"]), run["peaks"])
        for _, rep in points(run))
    return share(least, device_s)
