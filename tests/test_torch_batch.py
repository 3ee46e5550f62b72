"""The batched lambda-path engine: the port (``repro_torch.core.batch``
and its estimator surface) against the JAX engine and against the port's
own sequential solve, in float64 on the CPU.

Against JAX: per-lane iteration and trial counts and the convergence
flags are EQUAL, Omega agrees to 1e-10 (torch and XLA sum products and
reductions in other orders: a few ulps on these iterates), and the
compaction telemetry (order, segments, occupancy, capacities) is equal.
Against the port's sequential solve: each lane is BIT-equal, the
reference's own contract for the compact engine."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import estimator as jest
from repro.core import batch as jbatch
from repro.core import costmodel as jcost
from repro.core import graphs
from repro.core import penalty as jpen
from repro_torch import convert
from repro_torch import estimator as test_
from repro_torch.core import batch as tbatch
from repro_torch.core import costmodel as tcost
from repro_torch.core import penalty as tpen
from repro_torch.core import prox as tprox
from repro_torch.kernels import ops as tops

from _torch_parity import x64  # noqa: F401

OMEGA_ATOL = 1e-10
SCALAR_RTOL = 1e-9
GRID = np.geomspace(0.4, 0.1, 6)
KW = dict(variant="cov", tol=1e-6, max_iters=400)


@pytest.fixture(scope="module")
def chain48(x64):
    prob = graphs.make_problem("chain", p=48, n=150, seed=0)
    return np.asarray(prob.s, np.float64)


def _stats_fields(st):
    return (st.schedule, st.n_lanes, st.chunk, st.segments, st.waves,
            tuple(st.occupancy), tuple(st.capacities), tuple(st.order),
            st.gemm, st.pilot_lane)


def _assert_lanes_match(jres, tres):
    for f in ("iters", "ls_total", "converged", "stalled"):
        np.testing.assert_array_equal(getattr(tres, f).numpy(),
                                      np.asarray(getattr(jres, f)),
                                      err_msg=f)
    np.testing.assert_allclose(tres.omega.numpy(), np.asarray(jres.omega),
                               rtol=0, atol=OMEGA_ATOL)


# ---------------------------------------------------------------------------
# port against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [32, 8])
def test_compact_matches_jax_engine(chain48, chunk):
    jres, jst = jbatch.solve_path_batched(
        jnp.asarray(chain48), jnp.asarray(GRID), 0.05, chunk=chunk,
        return_stats=True, **KW)
    tres, tst = tbatch.solve_path_batched(
        torch.as_tensor(chain48), GRID, 0.05, chunk=chunk,
        return_stats=True, **KW)
    _assert_lanes_match(jres, tres)
    assert _stats_fields(tst) == _stats_fields(jst)
    assert tst.summary() == jst.summary()


def test_monolithic_stats_match_jax(chain48):
    jres, jst = jbatch.solve_path_batched(
        jnp.asarray(chain48), jnp.asarray(GRID), 0.05,
        schedule="monolithic", return_stats=True, **KW)
    tres, tst = tbatch.solve_path_batched(
        torch.as_tensor(chain48), GRID, 0.05, schedule="monolithic",
        return_stats=True, **KW)
    _assert_lanes_match(jres, tres)
    assert _stats_fields(tst) == _stats_fields(jst)


def test_solve_batch_matches_jax_stacked(x64):
    lam1s = np.asarray([0.2, 0.25, 0.3])
    xs = np.stack([graphs.make_problem("chain", p=32, n=100, seed=k).x
                   for k in range(3)]).astype(np.float64)
    ss = np.einsum("bni,bnj->bij", xs, xs) / xs.shape[1]
    for variant, data in (("obs", xs), ("cov", ss)):
        jres, jst = jbatch.solve_batch(
            jnp.asarray(data), jnp.asarray(lam1s), 0.05, variant=variant,
            tol=1e-6, return_stats=True)
        tres, tst = tbatch.solve_batch(
            torch.as_tensor(data), torch.as_tensor(lam1s), 0.05,
            variant=variant, tol=1e-6, return_stats=True)
        _assert_lanes_match(jres, tres)
        assert _stats_fields(tst) == _stats_fields(jst)
        for k in range(3):
            seq = tprox.solve_reference(torch.as_tensor(data[k]),
                                        float(lam1s[k]), 0.05,
                                        variant=variant, tol=1e-6)
            assert torch.equal(tres.omega[k], seq.omega)
            assert int(tres.iters[k]) == seq.iters


def test_solve_batch_rejects_unstacked_data():
    with pytest.raises(ValueError, match="stacked"):
        tbatch.solve_batch(torch.eye(8, dtype=torch.float64), 0.2)


def test_fit_batch_reports_match_jax(x64):
    xs = np.stack([graphs.make_problem("chain", p=24, n=80, seed=k).x
                   for k in range(3)]).astype(np.float64)
    kw = dict(variant="cov", tol=1e-6, batch_chunk=8)
    jrep = jest.fit_batch(x=jnp.asarray(xs), lam1=[0.2, 0.25, 0.3],
                          lam2=0.05, **kw)
    trep = test_.fit_batch(x=xs, lam1=[0.2, 0.25, 0.3], lam2=0.05,
                           device="cpu", **kw)
    assert isinstance(trep, test_.BatchReport) and len(trep) == 3
    for jr, tr in zip(jrep, trep):
        for f in ("iters", "ls_total", "converged", "stalled", "lam1",
                  "backend", "variant", "sparse_matmul", "penalty"):
            assert getattr(tr, f) == getattr(jr, f), f
        np.testing.assert_allclose(tr.objective, jr.objective,
                                   rtol=SCALAR_RTOL)
        np.testing.assert_allclose(tr.omega.numpy(), np.asarray(jr.omega),
                                   rtol=0, atol=OMEGA_ATOL)
    assert _stats_fields(trep.stats) == _stats_fields(jrep.stats)
    assert trep.all_converged and not trep.any_stalled
    assert "batch total" in trep.summary()
    # the estimator method runs the estimator's family with lam overrides
    est = test_.ConcordEstimator(lam1=0.2, lam2=0.05, config=test_.
                                 SolverConfig(device="cpu", **kw))
    again = est.fit_batch(x=xs, lam1=[0.2, 0.25, 0.3])
    assert [r.iters for r in again] == [r.iters for r in trep]
    assert est.report_ is again.reports[-1]


@pytest.mark.parametrize("mode", ["batched", "auto"])
@pytest.mark.parametrize("adaptive", [False, True])
def test_fit_path_matches_jax_facade(chain48, mode, adaptive):
    grid = list(np.geomspace(0.4, 0.08, 8))
    cfg = dict(backend="reference", variant="cov", tol=1e-6,
               tau_schedule="greedy", batch_chunk=8)
    je = jest.ConcordEstimator(lam1=0.2, lam2=0.05,
                               config=jest.SolverConfig(**cfg))
    te = test_.ConcordEstimator(lam1=0.2, lam2=0.05,
                                config=test_.SolverConfig(device="cpu",
                                                          **cfg))
    jp = je.fit_path(s=jnp.asarray(chain48), n_samples=150, lam1_grid=grid,
                     mode=mode, adaptive=adaptive)
    tp = te.fit_path(s=chain48, n_samples=150, lam1_grid=grid, mode=mode,
                     adaptive=adaptive)
    assert tp.mode == jp.mode == "batched"
    assert tp.adaptive == jp.adaptive == adaptive
    pairs = [(jp, tp)] + ([(jp.stage1, tp.stage1)] if adaptive else [])
    for jpath, tpath in pairs:
        assert tpath.lam1_grid == jpath.lam1_grid
        for jr, tr in zip(jpath, tpath):
            for f in ("iters", "ls_total", "converged", "stalled",
                      "penalty", "backend"):
                assert getattr(tr, f) == getattr(jr, f), f
            np.testing.assert_allclose(tr.omega.numpy(),
                                       np.asarray(jr.omega), rtol=0,
                                       atol=OMEGA_ATOL)
            np.testing.assert_allclose(tr.bic, jr.bic, rtol=SCALAR_RTOL)
        assert tpath.best_bic().lam1 == jpath.best_bic().lam1
        assert _stats_fields(tpath.batch_stats) == \
            _stats_fields(jpath.batch_stats)
    assert tp.batch_stats.summary() in tp.summary()
    assert te.report_ is tp.reports[-1]


# ---------------------------------------------------------------------------
# port against itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau_schedule", ["restart", "greedy"])
def test_each_lane_bit_equals_its_sequential_solve(chain48, tau_schedule):
    s = torch.as_tensor(chain48)
    res, st = tbatch.solve_path_batched(s, GRID, 0.05, return_stats=True,
                                        tau_schedule=tau_schedule, **KW)
    assert st.schedule == "compact" and st.n_lanes == len(GRID)
    for i, lam1 in enumerate(GRID):
        seq = tprox.solve_reference(s, float(lam1), 0.05,
                                    tau_schedule=tau_schedule, **KW)
        assert torch.equal(res.omega[i], seq.omega)
        assert (int(res.iters[i]), int(res.ls_total[i]),
                bool(res.converged[i]), bool(res.stalled[i])) == (
            seq.iters, seq.ls_total, seq.converged, seq.stalled)
        assert float(res.g_final[i]) == seq.g_final


def test_monolithic_equals_compact(chain48):
    s = torch.as_tensor(chain48)
    comp = tbatch.solve_path_batched(s, GRID, 0.05, **KW)
    mono = tbatch.solve_path_batched(s, GRID, 0.05, schedule="monolithic",
                                     **KW)
    for f in dataclasses.fields(comp):
        assert torch.equal(getattr(mono, f.name), getattr(comp, f.name))


def test_chunk8_occupancy_timeline_is_consistent(chain48):
    _, st = tbatch.solve_path_batched(torch.as_tensor(chain48), GRID, 0.05,
                                      chunk=8, return_stats=True, **KW)
    occ, cap = np.asarray(st.occupancy), np.asarray(st.capacities)
    assert occ.shape == cap.shape
    assert int(occ.sum()) == st.lane_steps
    assert int(cap.sum()) == st.padded_lane_steps
    assert np.all(occ <= cap) and np.all(occ >= 1)
    assert 0.0 < st.mean_occupancy <= 1.0
    assert st.segments > 1


def test_kernel_route_matches_plain_route(x64):
    """use_pallas=True takes the path-step route (its plain version on the
    CPU): the same trajectories, Omega within 1e-9 (its stats are summed
    in another order than the per-lane dots); no launch is counted."""
    prob = graphs.make_problem("chain", p=24, n=80, seed=2)
    s = torch.as_tensor(np.asarray(prob.s, np.float64))
    grid = np.geomspace(0.35, 0.12, 4)
    kw = dict(variant="cov", tol=1e-6, max_iters=300)
    tops.reset_launches()
    base = tbatch.solve_path_batched(s, grid, 0.05, **kw)
    fused = tbatch.solve_path_batched(s, grid, 0.05, use_pallas=True, **kw)
    assert torch.equal(fused.iters, base.iters)
    assert torch.equal(fused.ls_total, base.ls_total)
    np.testing.assert_allclose(fused.omega.numpy(), base.omega.numpy(),
                               rtol=0, atol=1e-9)
    assert tops.LAUNCHES["fused_path_step"] == 0


def test_weighted_kernel_route_with_lane_weights(x64):
    """Per-lane (B, p, p) weights with inf entries ride the weighted route
    of the path step and match the plain route."""
    prob = graphs.make_problem("chain", p=24, n=80, seed=2)
    s = torch.as_tensor(np.asarray(prob.s, np.float64))
    grid = np.asarray([0.3, 0.2, 0.15])
    rng = np.random.default_rng(9)
    w = rng.uniform(0.5, 2.0, (3, 24, 24))
    w = 0.5 * (w + w.transpose(0, 2, 1))
    w[:, 0, 20] = w[:, 20, 0] = np.inf
    spec = tpen.PenaltySpec("weighted_l1", 0.0, 0.05, weights=w)
    kw = dict(penalty=spec, variant="cov", tol=1e-6, max_iters=300)
    base = tbatch.solve_path_batched(s, grid, **kw)
    fused = tbatch.solve_path_batched(s, grid, use_pallas=True, **kw)
    assert torch.equal(fused.iters, base.iters)
    np.testing.assert_allclose(fused.omega.numpy(), base.omega.numpy(),
                               rtol=0, atol=1e-9)
    assert bool((base.omega[:, 0, 20] == 0).all())
    for i in range(3):
        seq = tprox.solve_reference(
            s, penalty=tpen.PenaltySpec.weighted_l1(grid[i], w[i], 0.05),
            variant="cov", tol=1e-6, max_iters=300)
        assert torch.equal(base.omega[i], seq.omega)


def test_pilot_lanes_equal_their_sequential_twins(chain48):
    s = torch.as_tensor(chain48)
    res, st = tbatch.solve_path_batched(s, GRID, 0.05, warm_start="pilot",
                                        return_stats=True, **KW)
    jres, jst = jbatch.solve_path_batched(
        jnp.asarray(chain48), jnp.asarray(GRID), 0.05, warm_start="pilot",
        return_stats=True, **KW)
    _assert_lanes_match(jres, res)
    assert _stats_fields(st) == _stats_fields(jst)
    pilot = st.pilot_lane
    assert 0 <= pilot < len(GRID)
    for i in (pilot, 0, len(GRID) - 1):
        om0 = None if i == pilot else res.omega[pilot]
        seq = tprox.solve_reference(s, float(GRID[i]), 0.05, omega0=om0,
                                    **KW)
        assert torch.equal(res.omega[i], seq.omega)
        assert (int(res.iters[i]), int(res.ls_total[i])) == (seq.iters,
                                                             seq.ls_total)
    with pytest.raises(ValueError, match="pilot"):
        tbatch.solve_path_batched(s, GRID, 0.05, warm_start="pilot",
                                  omega0=torch.eye(48, dtype=s.dtype))


def test_host_gemm_matches_device_gemm_and_is_wave_invariant(chain48):
    s = torch.as_tensor(chain48)
    dev = tbatch.solve_path_batched(s, GRID, 0.05, **KW)
    host, st = tbatch.solve_path_batched(s, GRID, 0.05, gemm="host",
                                         return_stats=True, **KW)
    solo = tbatch.solve_path_batched(s, GRID, 0.05, gemm="host",
                                     max_lanes=1, **KW)
    assert st.gemm == "host" and "[compact/host]" in st.summary()
    assert torch.equal(host.iters, dev.iters)
    np.testing.assert_allclose(host.omega.numpy(), dev.omega.numpy(),
                               rtol=0, atol=1e-8)
    assert torch.equal(host.omega, solo.omega)
    assert torch.equal(host.iters, solo.iters)
    with pytest.raises(ValueError, match="mutually"):
        tbatch.solve_path_batched(s, GRID, 0.05, gemm="host",
                                  use_pallas=True, **KW)


# ---------------------------------------------------------------------------
# pure-Python pieces
# ---------------------------------------------------------------------------

def test_capacity_ladder_and_tiers_match():
    for n in range(1, 70):
        assert tbatch.capacity_ladder(n) == jbatch.capacity_ladder(n)
        for b in (n, n + 5):
            assert tbatch._capacity(n, b) == jbatch._capacity(n, b)


@pytest.mark.parametrize("kw", [
    {}, dict(tau_schedule="greedy", chunk=8, gemm="host",
             warm_start="pilot"),
    dict(tau_schedule="warm", chunk=4), dict(gemm="host", max_iters=50),
], ids=["plain", "tuned", "warm", "host-capped"])
def test_cost_model_path_decision_matches(kw):
    for grid in (np.geomspace(0.4, 0.08, 8), [0.2], [], [0.3, 0.29],
                 np.linspace(0.05, 0.5, 12)):
        assert tcost.choose_path_mode(grid, **kw) == \
            jcost.choose_path_mode(grid, **kw)
        if len(grid):
            assert tcost.predict_batched_speedup(grid, **kw) == \
                jcost.predict_batched_speedup(grid, **kw)
            np.testing.assert_array_equal(
                tcost.predict_path_iters(grid), jcost.predict_path_iters(grid))
    grid = np.geomspace(0.4, 0.08, 8)
    tuned = dict(tau_schedule="greedy", chunk=8, gemm="host",
                 warm_start="pilot")
    assert tcost.choose_path_mode(grid, **tuned) == "batched"
    assert tcost.predict_batched_speedup(grid, **tuned) > \
        tcost.predict_batched_speedup(grid)


def test_adaptive_weights_match(x64):
    rng = np.random.default_rng(2)
    om = rng.standard_normal((12, 12)) * (rng.random((12, 12)) < 0.3)
    for kw in ({}, dict(eps=1e-2), dict(normalize=False)):
        np.testing.assert_array_equal(
            tpen.adaptive_weights(torch.as_tensor(om), **kw),
            jpen.adaptive_weights(jnp.asarray(om), **kw))
    with pytest.raises(ValueError):
        tpen.adaptive_weights(np.ones((2, 3)))


def test_lane_batched_spec_axes_and_lanes(x64):
    b, p = 3, 5
    lam1 = np.asarray([0.1, 0.2, 0.3])
    w = np.abs(np.random.default_rng(1).standard_normal((b, p, p)))
    for weights in (w, w[0]):
        jspec = jpen.PenaltySpec("weighted_l1", jnp.asarray(lam1), 0.05,
                                 weights=jnp.asarray(weights))
        tspec = tpen.PenaltySpec("weighted_l1", lam1, 0.05, weights=weights)
        assert tspec.batch_axes(b) == jspec.batch_axes(b)
        for i in range(b):
            jl, tl = jspec.lane(i, b), tspec.lane(i, b)
            assert float(tl.lam1) == float(jl.lam1)
            np.testing.assert_array_equal(np.asarray(tl.weights),
                                          np.asarray(jl.weights))
    scad = tpen.PenaltySpec("scad", lam1, shape=np.asarray([3.0, 3.7, 4.0]))
    assert scad.batch_axes(b) == [0, None, 0]
    assert scad.lane(1, b).label() == "scad:3.7"
    assert scad.label() == "scad"
    assert tspec.pallas_ok and tspec.kernel_ok


def test_lane_batched_prox_equals_per_lane_prox(x64):
    rng = np.random.default_rng(4)
    z = torch.as_tensor(rng.standard_normal((3, 6, 6)))
    tau = torch.as_tensor([0.5, 0.8, 1.0])
    for spec in (tpen.PenaltySpec("l1", torch.as_tensor([0.1, 0.2, 0.3])),
                 tpen.PenaltySpec("scad", torch.as_tensor([0.1, 0.2, 0.3]),
                                  shape=torch.as_tensor([3.0, 3.7, 4.0])),
                 tpen.PenaltySpec("mcp", torch.as_tensor([0.1, 0.2, 0.3]),
                                  shape=torch.as_tensor([2.0, 3.0, 4.0]))):
        out = spec.prox(z.clone(), tau)
        for i in range(3):
            one = spec.lane(i, 3).prox(z[i].clone(), float(tau[i]))
            assert torch.equal(out[i], one), spec.kind
        assert torch.equal(out.diagonal(dim1=-2, dim2=-1),
                           z.diagonal(dim1=-2, dim2=-1))


def test_convert_carries_lane_batched_specs(x64):
    w = np.abs(np.random.default_rng(3).standard_normal((2, 4, 4))) + 0.1
    w = 0.5 * (w + w.transpose(0, 2, 1))
    spec = convert.penalty_from_numpy("weighted_l1", np.asarray([0.1, 0.2]),
                                      0.05, weights=w)
    assert spec.batch_axes(2) == [0, None, 0]
    assert float(spec.lam1[1]) == 0.2 and spec.weights.shape == (2, 4, 4)
    scalar = convert.penalty_from_numpy("l1", np.float64(0.3), 0.05)
    assert scalar.lam1 == 0.3 and isinstance(scalar.lam1, float)
    bad = w.copy()
    bad[1, 0, 1] = -1.0
    with pytest.raises(ValueError, match="nonnegative"):
        convert.penalty_from_numpy("weighted_l1", [0.1, 0.2], weights=bad)


def test_batched_entry_points_need_a_device_or_cpu(chain48):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None is valid here")
    est = test_.ConcordEstimator(lam1=0.3)
    for call in (lambda: est.fit_path(s=chain48, n_samples=150,
                                      lam1_grid=[0.3, 0.2], mode="batched"),
                 lambda: est.fit_batch(s=np.stack([chain48, chain48]))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
