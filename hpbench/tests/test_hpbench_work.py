"""The work counts against shapes counted by hand, and their independence
from how the program tiles its products."""
from __future__ import annotations

import pytest

from hpbench.harness.peaks import H100_SXM
from hpbench.work import least_seconds, omega_product, prox, solve

P, N = 16384, 8192


def test_omega_product():
    nnz = 3 * P - 2
    assert omega_product.flops(P, P, nnz) == 2 * nnz * P
    assert omega_product.bytes_moved(P, P, nnz) == 8 * (nnz + 2 * P * P)
    assert omega_product.dense_flops(4096, 1200, 4096) == 2 * 4096 * 1200 * 4096
    assert omega_product.dense_bytes(2, 3, 5) == 8 * (6 + 15 + 10)
    # the product at p = 16384 is bound by its bytes: 4.3 GB at 3.35 TB/s
    t = least_seconds(omega_product.flops(P, P, nnz),
                      omega_product.bytes_moved(P, P, nnz), H100_SXM)
    assert t == pytest.approx(8 * (nnz + 2 * P * P) / 3.35e12)


def test_prox():
    assert prox.flops(P) == 7 * P * P
    assert prox.bytes_moved(P) == 8 * (2 * P * P + 5 * 128 * 128)
    assert prox.bytes_moved(100, block=32) == 8 * (2 * 100 * 100 + 5 * 16)
    t = least_seconds(prox.flops(P), prox.bytes_moved(P), H100_SXM)
    assert t == pytest.approx(1.282e-3, rel=2e-3)


def test_solve():
    pk = H100_SXM
    # Cov: every trial and the first product read S once (bytes-bound)
    assert solve.cov_seconds(P, 81, 3 * P, pk) == pytest.approx(
        82 * 8 * P * P / 3.35e12)
    assert solve.bic_seconds(P, 3 * P, pk) == pytest.approx(
        8 * P * P / 3.35e12)
    # Obs: the gradient product is flop-bound, once per outer iteration
    p, n = 4096, 1200
    grad = 2 * n * p * p / 67e12
    trial = 8 * (p * p + n * p) / 3.35e12
    assert solve.obs_seconds(p, n, 10, 25, 5 * p, pk) == pytest.approx(
        10 * grad + 26 * trial)


def _path_rows(block: int):
    from repro_torch.core.penalty import PenaltySpec
    from repro_torch.estimator import ConcordEstimator, SolverConfig
    from hpbench.harness import generate
    from hpbench.reference import concord
    x = generate.datasets({"p": 96, "n": 64, "graph": {
        "kind": "chain", "weight": 0.4}}, 1, 5, "cpu")[0]
    cfg = SolverConfig(backend="reference", variant="cov", dtype="float64",
                       use_pallas=True, sparse_matmul="on",
                       sparse_threshold=1.0, sparse_block=block,
                       device="cpu")
    est = ConcordEstimator(penalty=PenaltySpec.l1(0.3, 0.05), config=cfg)
    path = est.fit_path(s=concord.sample_covariance(x),
                        lam1_grid=[0.3, 0.2, 0.15], n_samples=64)
    return [(r.ls_total, r.nnz_per_row * 96, r.block_density)
            for r in path]


def test_required_work_does_not_follow_the_tiling():
    """The program at two tile sizes (``sparse_block``): its occupied-block
    share differs, the work the benchmark counts does not."""
    a, b = _path_rows(8), _path_rows(32)
    assert [r[2] for r in a] != [r[2] for r in b]

    def least(rows):
        return sum(solve.cov_seconds(96, t, nnz, H100_SXM)
                   + (t + 2) * least_seconds(
                       omega_product.flops(96, 96, nnz),
                       omega_product.bytes_moved(96, 96, nnz), H100_SXM)
                   for t, nnz, _ in rows)

    assert [r[:2] for r in a] == [r[:2] for r in b]
    assert least(a) == least(b)
