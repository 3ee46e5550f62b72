"""The port's estimator facade against the JAX facade: ``fit``,
``fit_cov`` and ``fit_path`` with the reference and auto backends on the
CPU, the cost model, the converters, and the later-slice knobs that must
raise rather than run a different solve."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import estimator as jest
from repro.core import costmodel as jcost
from repro.core import graphs
from repro.core import prox as jprox
from repro.estimator import report as jreport
from repro_torch import convert
from repro_torch import estimator as test_
from repro_torch.core import costmodel as tcost
from repro_torch.core import prox as tprox
from repro_torch.estimator import report as treport

from _torch_parity import x64  # noqa: F401

#: float64 parity: Omega to 1e-10 (summation order, see test_torch_prox),
#: report scalars derived from it to 1e-9 relative
OMEGA_ATOL = 1e-10
SCALAR_RTOL = 1e-9

KNOBS = dict(use_pallas=True, sparse_matmul="on", sparse_block=8,
             sparse_threshold=0.5)


@pytest.fixture(scope="module")
def data():
    prob = graphs.make_problem("chain", p=48, n=150, seed=3)
    return np.asarray(prob.x, np.float64), np.asarray(prob.s, np.float64)


def _pair(backend, variant, penalty="l1", lam1=0.3):
    jcfg = jest.SolverConfig(backend=backend, variant=variant, **KNOBS)
    tcfg = test_.SolverConfig(backend=backend, variant=variant,
                              device="cpu", **KNOBS)
    return (jest.ConcordEstimator(lam1=lam1, lam2=0.05, penalty=penalty,
                                  config=jcfg),
            test_.ConcordEstimator(lam1=lam1, lam2=0.05, penalty=penalty,
                                   config=tcfg))


def _assert_reports(want, got):
    for f in ("iters", "ls_total", "converged", "stalled", "variant",
              "penalty", "sparse_matmul", "lam1", "lam2"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("objective", "objective_smooth", "nnz_per_row",
              "block_density"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=SCALAR_RTOL, err_msg=f)
    assert isinstance(got.omega, torch.Tensor) and got.device == "cpu"
    np.testing.assert_allclose(got.omega.numpy(), np.asarray(want.omega),
                               rtol=0, atol=OMEGA_ATOL)


@pytest.mark.parametrize("backend", ["reference", "auto"])
@pytest.mark.parametrize("variant", ["cov", "obs"])
def test_fit_matches(x64, data, backend, variant):
    x, _ = data
    je, te = _pair(backend, variant)
    je.fit(jnp.asarray(x))
    te.fit(x)
    _assert_reports(je.report_, te.report_)
    assert te.report_.backend == "reference" == je.report_.backend
    assert te.n_iter_ == je.n_iter_


@pytest.mark.parametrize("backend", ["reference", "auto"])
@pytest.mark.parametrize("penalty", ["l1", "scad:3.7"])
def test_fit_cov_matches(x64, data, backend, penalty):
    _, s = data
    je, te = _pair(backend, "cov", penalty=penalty)
    je.fit_cov(jnp.asarray(s), n_samples=150)
    te.fit_cov(torch.as_tensor(s), n_samples=150)
    _assert_reports(je.report_, te.report_)


@pytest.mark.parametrize("backend", ["reference", "auto"])
def test_fit_path_matches(x64, data, backend):
    x, _ = data
    je, te = _pair(backend, "cov")
    jpath = je.fit_path(jnp.asarray(x), [0.3, 0.25, 0.2])
    tpath = te.fit_path(x, [0.2, 0.3, 0.25])          # sorted descending
    assert tpath.lam1_grid == jpath.lam1_grid == (0.3, 0.25, 0.2)
    for jr, tr in zip(jpath, tpath):
        _assert_reports(jr, tr)
        np.testing.assert_allclose(tr.bic, jr.bic, rtol=SCALAR_RTOL)
    assert tpath.best_bic().lam1 == jpath.best_bic().lam1
    assert (tpath.total_iters, tpath.total_ls) == (jpath.total_iters,
                                                   jpath.total_ls)
    assert te.report_ is tpath[-1]
    assert "path total" in tpath.summary()
    for k, v in tpath.telemetry.items():
        assert len(v) == 3, k


def test_fit_path_cold_and_unscored(x64, data):
    _, s = data
    je, te = _pair("reference", "cov")
    jpath = je.fit_path(s=jnp.asarray(s), lam1_grid=[0.3, 0.2],
                        warm_start=False, score_bic=False)
    tpath = te.fit_path(s=s, lam1_grid=[0.3, 0.2], warm_start=False,
                        score_bic=False)
    for jr, tr in zip(jpath, tpath):
        _assert_reports(jr, tr)
        assert tr.bic is None
    with pytest.raises(ValueError, match="no BIC"):
        tpath.best_bic()
    with pytest.raises(ValueError, match="sample count"):
        te.fit_path(s=s, lam1_grid=[0.3])


def test_functional_facade_matches(x64, data):
    x, s = data
    jr = jest.fit(jnp.asarray(x), lam1=0.3, lam2=0.05, backend="reference",
                  variant="obs", **KNOBS)
    tr = test_.fit(x, lam1=0.3, lam2=0.05, backend="reference",
                   variant="obs", device="cpu", **KNOBS)
    _assert_reports(jr, tr)
    jp = jest.fit_path(s=jnp.asarray(s), lam1_grid=[0.3, 0.2], lam2=0.05,
                       n_samples=150, backend="reference", variant="cov")
    tp = test_.fit_path(s=s, lam1_grid=[0.3, 0.2], lam2=0.05,
                        n_samples=150, backend="reference", variant="cov",
                        device="cpu")
    assert tp.best_bic().lam1 == jp.best_bic().lam1


def test_pseudo_bic_matches(x64, data):
    _, s = data
    om = np.array(jprox.solve_reference(jnp.asarray(s), 0.3, 0.05).omega)
    np.testing.assert_allclose(treport.pseudo_bic(torch.as_tensor(om), s, 150),
                               jreport.pseudo_bic(om, s, 150), rtol=1e-12)
    bad = om.copy()
    bad[0, 0] = -1.0
    assert treport.pseudo_bic(torch.as_tensor(bad), s, 150) == float("inf")


def test_convert_carries_a_jax_setup_across(x64, data):
    """JAX spec/config/warm start -> plain numpy and dicts -> the port:
    the same solve."""
    _, s = data
    rng = np.random.default_rng(0)
    w = 0.5 + np.abs(rng.standard_normal((48, 48)))
    w = 0.5 * (w + w.T)
    jspec = jest.PenaltySpec.weighted_l1(0.25, jnp.asarray(w), 0.05)
    jcfg = jest.SolverConfig(backend="reference", variant="cov", **KNOBS)
    warm = np.array(jprox.solve_reference(jnp.asarray(s), 0.3, 0.05).omega)
    want = jest.ConcordEstimator(penalty=jspec, config=jcfg).fit_cov(
        jnp.asarray(s), n_samples=150, omega0=jnp.asarray(warm)).report_
    tspec = convert.penalty_from_numpy(
        jspec.kind, jspec.lam1, jspec.lam2, shape=jspec.shape,
        weights=np.asarray(jspec.weights))
    tcfg = convert.config_from_mapping(dataclasses.asdict(jcfg),
                                       device="cpu")
    warm_t = convert.omega_from_numpy(warm, device="cpu")
    got = test_.ConcordEstimator(penalty=tspec, config=tcfg).fit_cov(
        s, n_samples=150, omega0=warm_t).report_
    _assert_reports(want, got)
    with pytest.raises(ValueError, match="unknown SolverConfig"):
        convert.config_from_mapping({"mesh": 2})


def test_config_defaults_and_validation_match():
    jd = dataclasses.asdict(jest.SolverConfig())
    td = dataclasses.asdict(test_.SolverConfig())
    assert td.pop("device") is None
    assert td == jd
    for bad in [dict(variant="x"), dict(tol=0.0), dict(max_iters=0),
                dict(max_ls=0), dict(dtype="int8"), dict(sparse_matmul="x"),
                dict(sparse_block=0), dict(sparse_threshold=1.5),
                dict(tau_schedule="x"), dict(penalty="lasso"),
                dict(c_x=0), dict(backend="")]:
        with pytest.raises(ValueError):
            jest.SolverConfig(**bad)
        with pytest.raises(ValueError):
            test_.SolverConfig(**bad)


@pytest.mark.parametrize("field,value", [
    ("c_x", 2), ("c_omega", 2), ("obs", "summary"),
    ("backend", "distributed"),
])
def test_later_slice_knobs_raise(field, value):
    """A knob of a later slice (obs) raises naming it; the distributed
    slice's knobs have landed and are taken as the reference takes them."""
    want = jest.SolverConfig(**{field: value})   # valid in the reference
    if field == "obs":
        with pytest.raises(NotImplementedError, match="slice"):
            test_.SolverConfig(**{field: value})
    else:
        got = test_.SolverConfig(**{field: value})
        assert getattr(got, field) == getattr(want, field) == value


@pytest.mark.parametrize("field,value", [
    ("batch_schedule", "monolithic"), ("batch_chunk", 8),
    ("batch_max_lanes", 2), ("batch_gemm", "host"),
    ("batch_warm_start", "pilot"),
])
def test_batch_knobs_are_accepted(field, value):
    assert getattr(jest.SolverConfig(**{field: value}), field) == value
    assert getattr(test_.SolverConfig(**{field: value}), field) == value


def test_single_device_grid_is_accepted():
    cfg = test_.SolverConfig(c_x=1, c_omega=1, device="cpu")
    assert (cfg.c_x, cfg.c_omega) == (1, 1)


def test_later_slice_entry_points_raise(data):
    x, s = data
    est = test_.ConcordEstimator(
        lam1=0.3, config=test_.SolverConfig(device="cpu"))
    # the streaming entry points run since the data slice
    # (tests/test_torch_data.py); their multi-process twin runs since the
    # distributed slice (one process here: the plain Gram of its rows),
    # and fit_gram refuses what is not a Gram, as the reference
    from repro_torch.data import compute_gram, distributed_gram
    got = distributed_gram([x[:75], x[75:]], device="cpu")
    want = compute_gram(x, device="cpu")
    assert (got.n, got.p, got.n_chunks) == (150, x.shape[1], 2)
    np.testing.assert_allclose(got.s.numpy(), want.s.numpy(), rtol=0,
                               atol=1e-12)
    with pytest.raises(TypeError, match="GramResult-like"):
        est.fit_gram(object())
    with pytest.raises(ValueError, match="mode"):
        est.fit_path(x, [0.3], mode="fast")
    with pytest.raises(ValueError, match="lam1_grid"):
        est.fit_path(x, [])


def test_auto_backend_refuses_several_devices(data):
    """Two devices without a process group of two: the distributed
    backend that auto picks has no ranks to run on, and says so."""
    _, s = data
    est = test_.ConcordEstimator(lam1=0.3, config=test_.SolverConfig(
        backend="auto", n_devices=2, device="cpu"))
    with pytest.raises(ValueError, match="process group"):
        est.fit_cov(s, n_samples=150)


def test_problem_validation_matches(data):
    x, s = data
    bad_s = s.copy()
    bad_s[0, 1] += 1.0
    nan_x = x.copy()
    nan_x[0, 0] = np.nan
    cases = [dict(), dict(s=bad_s), dict(x=nan_x), dict(x=x[0]),
             dict(s=s[:3]), dict(s=s, n_samples=0),
             dict(x=x, s=s[:3, :3])]
    for kw in cases:
        with pytest.raises(ValueError):
            jest.Problem.from_data(**kw)
        with pytest.raises(ValueError):
            test_.Problem.from_data(device="cpu", **kw)


def test_estimator_lam_setters_and_registry(data):
    est = test_.ConcordEstimator(lam1=0.3, lam2=0.1,
                                 config=test_.SolverConfig(device="cpu"))
    est.lam1 = 0.2
    est.lam2 = 0.01
    assert (est.penalty.lam1, est.penalty.lam2) == (0.2, 0.01)
    assert test_.available_backends() == ["auto", "distributed",
                                          "reference"]
    assert test_.get_backend("distributed") is test_.distributed_backend
    with pytest.raises(ValueError, match="unknown backend"):
        test_.get_backend("nccl")
    with pytest.raises(ValueError, match="already registered"):
        test_.register_backend("reference", test_.reference_backend)
    with pytest.raises(TypeError):
        test_.ConcordEstimator(config=object())


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

def _same_machine():
    m = jcost.Machine()
    return m, tcost.Machine(**dataclasses.asdict(m))


@pytest.mark.parametrize("p,m,bs", [(512, 512, 128), (4096, 300, 64),
                                    (16384, 16384, 128)])
def test_crossover_matches_with_the_same_machine(p, m, bs):
    jm, tm = _same_machine()
    assert tcost.crossover_density(p, m, bs, tm) == \
        jcost.crossover_density(p, m, bs, jm)


@pytest.mark.parametrize("p,n,d", [(1000, 200, 5.0), (500, 2000, 50.0),
                                   (16384, 1200, 3.0)])
def test_tune_matches_with_the_same_machine(p, n, d):
    jm, tm = _same_machine()
    js, ts = jcost.ProblemShape(p, n, d), tcost.ProblemShape(p, n, d)
    for P in (1, 4):
        a, b = jcost.tune(js, P, jm), tcost.tune(ts, P, tm)
        assert (a.variant, a.c_x, a.c_omega, a.total) == \
            (b.variant, b.c_x, b.c_omega, b.total)


def test_port_defaults_to_the_h100_data_sheet():
    assert tcost.Machine() == tcost.H100
    assert tcost.H100.name == "h100_sxm" and tcost.H100.word_bytes == 8
    assert tcost.tune(tcost.ProblemShape(64, 200, 3.0), 1).variant in (
        "cov", "obs")
    with pytest.raises(ValueError, match="no feasible"):
        tcost.tune(tcost.ProblemShape(10**7, 10, 3.0), 1)


def test_tau_schedules_are_the_same_names():
    assert tprox.TAU_SCHEDULES == jprox.TAU_SCHEDULES
