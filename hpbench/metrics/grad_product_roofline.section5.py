"""grad_product_roofline.section5: the Obs gradient's product (Omega X^T) X
(p x n by n x p, dense in any implementation; ``core/prox.py``, span
``grad.obs``) against its roofline.  Device time: the dense f64 GEMMs
(cuBLAS ``gemm`` kernels; in this cell nothing else should run one).
Required work: the census's ``grad.obs`` count, each
``hpbench/work/omega_product.dense_flops / dense_bytes(p, n, p)``.  A
program without the census or the span reports nothing."""
from hpbench.harness.census import census
from hpbench.harness.readings import share
from hpbench.work import least_seconds, omega_product

UNIT = "%"
LAYER = "Obs gradient product (core/prox.py)"
MOVES = "path_s"
SOURCE = "device_trace"

KERNELS = ("gemm",)


def read(run):
    tr, c = run["trace"], census(run)
    if tr is None or c is None or not c.spans.get("grad.obs"):
        return None
    device_s, _ = tr.seconds_of(*KERNELS)
    p, n = run["config"]["p"], run["config"]["n"]
    one = least_seconds(omega_product.dense_flops(p, n, p),
                        omega_product.dense_bytes(p, n, p), run["peaks"])
    return share(c.spans["grad.obs"] * one, device_s)
