"""omega_product_roofline.backlog: the Obs solve's products' share of
their roofline.  Device time: the dense f64 GEMMs (cuBLAS; the batched
engine runs every product dense).  Required work
(``hpbench/work/omega_product.py``): per request, Omega X^T once per
trial and once to start (at its final nonzeros: a cold solve's iterates
grow from the identity's towards them, so the count reads high, as an
upper bound would), and the gradient's dense (Omega X^T) X once per
outer iteration."""
from hpbench.harness.readings import lanes, share
from hpbench.work import least_seconds, omega_product

UNIT = "%"
LAYER = "Omega-side products (per-lane torch.matmul in core/batch.py)"
MOVES = "requests_per_s"
SOURCE = "device_trace"

KERNELS = ("gemm",)


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    device_s, _ = tr.seconds_of(*KERNELS)
    p, n, peaks = run["config"]["p"], run["config"]["n"], run["peaks"]
    least = 0.0
    for _, rep in lanes(run):
        least += (rep["ls_total"] + 1) * least_seconds(
            omega_product.flops(p, n, rep["nnz"]),
            omega_product.bytes_moved(p, n, rep["nnz"]), peaks)
        least += rep["iters"] * least_seconds(
            omega_product.dense_flops(p, n, p),
            omega_product.dense_bytes(p, n, p), peaks)
    return share(least, device_s)
