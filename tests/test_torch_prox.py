"""The slice as a whole: the port's ``solve_reference`` against the JAX
reference on the parity fixture (chain graph, p = 64, n = 200, seed 1,
``MatmulPolicy("on", 8, 0.5)``), cov and obs, kernels on and off, l1,
weighted_l1 and scad.

Iteration and trial counts, the convergence flags and the final block
density must be EQUAL.  Omega must agree to 1e-10: torch and XLA sum the
matrix products and reductions in different orders, which moves the
float64 iterates by a few ulps (about 1e-16 on this problem), so 1e-10
leaves six orders of margin while still catching any difference in the
accepted steps."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import graphs as jgraphs
from repro.core import matops as jm
from repro.core import penalty as jpen
from repro.core import prox as jprox
from repro_torch import census
from repro_torch.core import graphs as tgraphs
from repro_torch.core import matops as tm
from repro_torch.core import penalty as tpen
from repro_torch.core import prox as tprox
from repro_torch.kernels import ops as kops

from _torch_parity import x64  # noqa: F401

OMEGA_ATOL = 1e-10


@pytest.fixture(scope="module")
def problem():
    prob = jgraphs.make_problem("chain", p=64, n=200, seed=1)
    return (np.asarray(prob.s, np.float64), np.asarray(prob.x, np.float64))


def _weights(p=64, seed=5):
    rng = np.random.default_rng(seed)
    w = 0.5 + np.abs(rng.standard_normal((p, p)))
    w = 0.5 * (w + w.T)
    far = np.abs(np.subtract.outer(np.arange(p), np.arange(p))) > 6
    w[far & (rng.random((p, p)) < 0.3)] = np.inf
    w = np.where(np.isinf(w) | np.isinf(w.T), np.inf, w)
    w[np.diag_indices(p)] = 0.0
    return w


def _specs(kind, lam1):
    if kind == "weighted_l1":
        w = _weights()
        return (jpen.PenaltySpec.weighted_l1(lam1, jnp.asarray(w), 0.05),
                tpen.PenaltySpec.weighted_l1(lam1, w, 0.05))
    if kind == "scad":
        return (jpen.PenaltySpec.scad(lam1, lam2=0.05),
                tpen.PenaltySpec.scad(lam1, lam2=0.05))
    return jpen.PenaltySpec.l1(lam1, 0.05), tpen.PenaltySpec.l1(lam1, 0.05)


def _solve_both(problem, variant, kernels, kind, lam1, **kw):
    s, x = problem
    data = s if variant == "cov" else x
    js, ts = _specs(kind, lam1)
    want = jprox.solve_reference(
        jnp.asarray(data), penalty=js, variant=variant,
        sparse_matmul=jm.MatmulPolicy("on", 8, 0.5), use_pallas=kernels,
        **kw)
    got = tprox.solve_reference(
        torch.as_tensor(data), penalty=ts, variant=variant,
        sparse_matmul=tm.MatmulPolicy("on", 8, 0.5), use_kernels=kernels,
        **kw)
    return want, got


def _assert_same_solve(want, got):
    assert (got.iters, got.ls_total) == (int(want.iters),
                                         int(want.ls_total))
    assert got.converged == bool(want.converged)
    assert got.stalled == bool(want.stalled)
    assert got.block_density == float(want.block_density)
    np.testing.assert_allclose(got.omega.numpy(), np.asarray(want.omega),
                               rtol=0, atol=OMEGA_ATOL)
    np.testing.assert_allclose(got.g_final, float(want.g_final), rtol=1e-12)


@pytest.mark.parametrize("lam1", [0.2, 0.3])
@pytest.mark.parametrize("kind", ["l1", "weighted_l1", "scad"])
@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("variant", ["cov", "obs"])
def test_solve_matches_reference(x64, problem, variant, kernels, kind, lam1):
    want, got = _solve_both(problem, variant, kernels, kind, lam1)
    _assert_same_solve(want, got)
    assert got.converged


def test_sparse_branch_runs_on_the_fixture(x64, problem, monkeypatch):
    """lam1 = 0.3 ends at block density 0.344 < 0.5: the block-sparse
    product must actually run, and the solve still matches."""
    calls = []
    real = tm.masked_matmul
    monkeypatch.setattr(tm, "masked_matmul",
                        lambda *a, **k: calls.append(k["capacity"])
                        or real(*a, **k))
    want, got = _solve_both(problem, "cov", True, "l1", 0.3)
    _assert_same_solve(want, got)
    assert got.block_density == pytest.approx(0.34375)
    assert calls, "the sparse branch never ran"


@pytest.mark.parametrize("variant", ["cov", "obs"])
def test_max_ls_one_reproduces_the_stall(x64, problem, variant):
    want, got = _solve_both(problem, variant, True, "l1", 0.3, max_ls=1)
    assert bool(want.stalled) and not bool(want.converged)
    _assert_same_solve(want, got)


@pytest.mark.parametrize("schedule", ["warm", "greedy"])
def test_tau_schedules_match(x64, problem, schedule):
    want, got = _solve_both(problem, "cov", False, "l1", 0.3,
                            tau_schedule=schedule)
    _assert_same_solve(want, got)


def test_warm_start_and_iteration_cap_match(x64, problem):
    s, _ = problem
    om0 = np.array(jprox.solve_reference(jnp.asarray(s), 0.3, 0.05).omega)
    want = jprox.solve_reference(jnp.asarray(s), 0.2, 0.05,
                                 omega0=jnp.asarray(om0), max_iters=3)
    got = tprox.solve_reference(torch.as_tensor(s), 0.2, 0.05,
                                omega0=torch.as_tensor(om0), max_iters=3)
    assert got.iters == 3 and not got.converged and not got.stalled
    _assert_same_solve(want, got)


def _unfused(monkeypatch):
    """Single-device ops without their trial op: the loop's unfused
    sparse branch (z, the prox and its mask, three inner products)."""
    real = tprox._ref_sparse_ops
    monkeypatch.setattr(tprox, "_ref_sparse_ops",
                        lambda *a: real(*a)[:3] + (None,))


@pytest.mark.parametrize("case", ["converge", "stall", "warm"])
@pytest.mark.parametrize("kind", ["l1", "weighted_l1", "scad"])
@pytest.mark.parametrize("variant", ["cov", "obs"])
def test_fused_trial_gives_the_unfused_trials_bits(problem, monkeypatch,
                                                   variant, kind, case):
    """The sparse loop's fused trial (the kernel's trial entry; on the
    CPU its plain twin) against the unfused composition: the same
    iterates, trial counts, objective, step and block density, bit for
    bit, from the identity, through a stall (max_ls 1) and from a warm
    start (whose ||Omega||^2 the fused loop takes once).  SCAD has no
    kernel prox: its trial is the plain composition inside the variant's
    trial op."""
    s, x = problem
    data = torch.as_tensor(s if variant == "cov" else x)
    kw = dict(penalty=_specs(kind, 0.3)[1], variant=variant,
              sparse_matmul=tm.MatmulPolicy("on", 8, 0.5), use_kernels=True)
    if case == "stall":
        kw["max_ls"] = 1
    elif case == "warm":
        kw["omega0"] = tprox.solve_reference(
            data, penalty=_specs(kind, 0.4)[1], variant=variant).omega
        kw["max_iters"] = 3
    kops.reset_launches()
    fused = tprox.solve_reference(data, **kw)
    fused_trials = census.CENSUS.spans.get("prox.fused_trial", 0)
    with monkeypatch.context() as m:
        _unfused(m)
        kops.reset_launches()
        plain = tprox.solve_reference(data, **kw)
        assert census.CENSUS.spans.get("prox.fused_trial", 0) == 0
    assert torch.equal(fused.omega, plain.omega)
    for field in ("iters", "ls_total", "converged", "stalled", "g_final",
                  "delta_final", "block_density"):
        assert getattr(fused, field) == getattr(plain, field), field
    assert fused_trials == (0 if kind == "scad" else fused.ls_total)
    if case == "stall":
        assert fused.stalled


def test_tau_start_matches(x64):
    for schedule in jprox.TAU_SCHEDULES:
        for step, prev in [(0, 1.0), (1, 0.25), (4, 0.7), (2, 0.125)]:
            want = float(jprox.tau_start(schedule, jnp.asarray(step), prev,
                                         1.0, jnp.float64))
            assert tprox.tau_start(schedule, step, prev, 1.0) == want


def test_guard_and_schedule_errors():
    g = torch.tensor(1.0, dtype=torch.float64)
    assert torch.isinf(tprox.guard_nonpos_diag(g, torch.tensor(0.0)))
    assert torch.isinf(tprox.guard_nonpos_diag(torch.tensor(float("nan")),
                                               torch.tensor(1.0)))
    assert tprox.guard_nonpos_diag(g, torch.tensor(0.5)) == 1.0
    with pytest.raises(ValueError):
        tprox.resolve_tau_schedule("fast", False)
    with pytest.raises(ValueError, match="variant"):
        tprox.solve_reference(torch.eye(4, dtype=torch.float64), 0.1,
                              variant="bad")
    with pytest.raises(ValueError, match="weights shape"):
        tprox.solve_reference(torch.eye(4, dtype=torch.float64),
                              penalty=tpen.PenaltySpec.weighted_l1(
                                  0.1, np.ones((3, 3))))


def test_graphs_copy_matches_reference():
    for kind in ("chain", "random"):
        a = jgraphs.make_problem(kind, p=20, n=30, seed=2)
        b = tgraphs.make_problem(kind, p=20, n=30, seed=2)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    om = jgraphs.chain_omega(12)
    assert jgraphs.ppv_fdr(om, om) == tgraphs.ppv_fdr(om, om)


def test_torch_sampler_has_the_right_covariance():
    """The on-device sampler draws other numbers than numpy from a seed;
    it must match in distribution: cov(X) ~ inv(Omega0)."""
    om = tgraphs.chain_omega(6, dtype=np.float64)
    gen = torch.Generator().manual_seed(0)
    x = tgraphs.sample_gaussian_torch(om, 40000, gen, "cpu")
    assert x.shape == (40000, 6) and x.dtype == torch.float64
    cov = (x.T @ x / x.shape[0]).numpy()
    np.testing.assert_allclose(cov, np.linalg.inv(om), atol=0.05)
