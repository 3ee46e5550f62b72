"""The port's observability package (``repro_torch.obs``) against
``repro.obs`` on the same inputs: the tracer and its exports (traces
cross between the packages both ways), the metrics and their exports,
the cost feed, the estimator's obs levels (bit-exact, telemetry, lazy
import), the comm reconciliation at world size 1 and on 4 spawned gloo
ranks, and the CLI's four subcommands."""
import json
import os
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.comm.grid import Grid1p5D as JGrid
from repro.core import graphs
from repro.obs import commwatch as jwatch
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch import estimator as test_
from repro_torch.comm.grid import Grid1p5D
from repro_torch.core import distributed as tdist
from repro_torch.core.costmodel import collective_wire_bytes
from repro_torch.obs import cli as tcli
from repro_torch.obs import commwatch as twatch
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace

from _torch_parity import x64  # noqa: F401
from test_torch_ranks import RankPool, facade, obs_cli, reconcile

REPO = Path(__file__).resolve().parents[1]

#: the reference's slow tests' grids at P = 4: (variant, c_x, c_omega)
GRIDS_4 = [("cov", 1, 1), ("cov", 2, 2), ("obs", 1, 1), ("obs", 1, 2)]


@pytest.fixture(autouse=True)
def _reset_obs_globals():
    """The tracers and registries are process-global singletons; leave
    both packages' off and empty so no test observes another's spans."""
    yield
    for tr in (jtrace, ttrace):
        if tr._TRACER is not None:
            tr._TRACER.set_mode("off")
            tr._TRACER.clear()
    for mt in (jmetrics, tmetrics):
        if mt._REGISTRY is not None:
            mt._REGISTRY.clear()


@pytest.fixture(scope="module")
def pool():
    made = RankPool(4)
    yield made
    made.close()


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def test_tracer_off_is_inert():
    t = ttrace.Tracer()
    with t.span("solve", p=8) as s:
        s.note(iters=3)
    t.event("tick")
    assert len(t) == 0 and t.snapshot() == ()


def test_tracer_records_spans_events_and_notes():
    t = ttrace.Tracer(mode="summary")
    with t.span("solve", cat="solver", p=8) as s:
        s.note(iters=3)
        t.event("checkpoint", step=1)
    spans = t.snapshot()
    assert [s.name for s in spans] == ["checkpoint", "solve"]
    ev, sp = spans
    assert ev.phase == "instant" and ev.duration == 0.0
    assert sp.phase == "span" and sp.duration >= 0.0
    assert sp.args == {"p": 8, "iters": 3} and ev.args == {"step": 1}


def test_tracer_summary_filters_trace_level_spans():
    t = ttrace.Tracer(mode="summary")
    with t.span("outer"):
        with t.span("inner", level="trace"):
            pass
    assert [s.name for s in t.snapshot()] == ["outer"]
    t.clear()
    t.set_mode("trace")
    with t.span("outer"):
        with t.span("inner", level="trace"):
            pass
    assert sorted(s.name for s in t.snapshot()) == ["inner", "outer"]
    with pytest.raises(ValueError, match="obs mode"):
        t.set_mode("verbose")


def test_tracer_ring_capacity_bounds_memory():
    t = ttrace.Tracer(mode="trace", capacity=4)
    for i in range(10):
        t.event("e", i=i)
    spans = t.snapshot()
    assert len(spans) == 4
    assert [s.args["i"] for s in spans] == [6, 7, 8, 9]
    assert ttrace.RING_CAPACITY == jtrace.RING_CAPACITY


def test_tracer_scoped_restores_mode():
    t = ttrace.Tracer(mode="off")
    with t.scoped("trace"):
        assert t.mode == "trace"
        t.event("inside")
    assert t.mode == "off" and len(t) == 1


def _record(pkg):
    """The same small trace through either package's tracer."""
    t = pkg.Tracer(mode="trace")
    with t.span("solve", cat="solver", p=16) as s:
        s.note(converged=True)
        t.event("mark", cat="batch", level="trace", wave=2)
    return t


@pytest.mark.parametrize("fmt", ["jsonl", "chrome"])
@pytest.mark.parametrize("writer,reader", [(jtrace, ttrace),
                                           (ttrace, jtrace),
                                           (ttrace, ttrace)],
                         ids=["ref-to-port", "port-to-ref", "port-to-port"])
def test_trace_files_cross_between_packages(tmp_path, fmt, writer, reader):
    """A JSONL or Chrome trace written by one package loads in the other
    with equal spans (Chrome: integer-microsecond slop on the clocks)."""
    t = _record(writer)
    path = tmp_path / ("trace.jsonl" if fmt == "jsonl" else "trace.json")
    n = (t.export_jsonl(path) if fmt == "jsonl" else t.export_chrome(path))
    assert n == 2
    back = (reader.load_jsonl(path) if fmt == "jsonl"
            else reader.load_chrome(path))
    assert len(back) == 2
    key = lambda s: s.t_start   # noqa: E731
    for orig, rt in zip(sorted(t.snapshot(), key=key), sorted(back, key=key)):
        if fmt == "jsonl":
            assert orig.to_json() == rt.to_json()
        else:
            assert (orig.name, orig.cat, orig.phase, orig.level,
                    orig.args) == (rt.name, rt.cat, rt.phase, rt.level,
                                   rt.args)
            assert abs(orig.t_start - rt.t_start) < 2e-6
            assert abs(orig.duration - rt.duration) < 2e-6
    if fmt == "chrome":
        assert "traceEvents" in json.loads(path.read_text())


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_counter_monotone_and_gauge():
    reg = tmetrics.MetricsRegistry()
    c = reg.counter("reqs", variant="cov")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("depth")
    g.set(7)
    assert g.value == 7.0
    assert reg.counter("reqs", variant="cov") is c
    assert len(reg) == 2


def test_registry_type_clash_raises():
    reg = tmetrics.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "bimodal"])
def test_histogram_quantiles_equal_the_reference(dist):
    """Same samples, same quantiles as ``repro.obs`` (exactly), and
    within one bucket's relative width of numpy's sample quantiles."""
    rng = np.random.default_rng(0)
    samples = {
        "lognormal": lambda: rng.lognormal(-6.0, 1.5, 5000),
        "uniform": lambda: rng.uniform(1e-3, 2.0, 3000),
        "bimodal": lambda: np.concatenate([rng.lognormal(-9, 0.3, 800),
                                           rng.lognormal(-1, 0.3, 200)]),
    }[dist]()
    h, jh = tmetrics.Histogram("lat"), jmetrics.Histogram("lat")
    for v in samples:
        h.observe(v)
        jh.observe(v)
    assert h.total == jh.total == len(samples)
    assert h.percentiles() == jh.percentiles()
    assert h.to_json() == jh.to_json()
    for q in (0.0, 0.25, 0.5, 0.95, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q)
    for q in (0.5, 0.95, 0.99):
        ref = float(np.quantile(samples, q))
        assert ref / h.growth <= h.quantile(q) <= ref * h.growth, (q, ref)
    assert h.min <= h.quantile(0.0) <= h.min * h.growth
    assert h.max / h.growth <= h.quantile(1.0) <= h.max


def test_histogram_single_sample_and_empty():
    h = tmetrics.Histogram("lat")
    assert np.isnan(h.quantile(0.5))
    h.observe(0.125)
    for q in (0.0, 0.5, 1.0):
        assert h.quantile(q) == pytest.approx(0.125)
    with pytest.raises(ValueError):
        h.quantile(1.5)


def _fill(pkg):
    reg = pkg.MetricsRegistry()
    reg.counter("repro_solves_total", variant="cov").inc(3)
    reg.gauge("repro_queue_depth").set(2)
    hist = reg.histogram("repro_solve_wall_seconds", variant="cov")
    for v in (0.01, 0.02, 0.04, 0.5, 1e-5):
        hist.observe(v)
    return reg


def test_prometheus_text_and_snapshot_equal_the_reference(tmp_path):
    reg, jreg = _fill(tmetrics), _fill(jmetrics)
    text = reg.to_prometheus()
    assert text == jreg.to_prometheus()
    assert "# TYPE repro_solves_total counter" in text
    assert 'repro_solves_total{variant="cov"} 3' in text
    assert "# TYPE repro_queue_depth gauge" in text
    assert "# TYPE repro_solve_wall_seconds summary" in text
    assert 'quantile="0.5"' in text
    assert 'repro_solve_wall_seconds_count{variant="cov"} 5' in text
    snap = reg.snapshot()
    assert snap == jreg.snapshot()
    assert snap['repro_solves_total{variant="cov"}'] == 3
    reg.export_json(tmp_path / "m.json")
    jreg.export_json(tmp_path / "j.json")
    assert (tmp_path / "m.json").read_text() == \
        (tmp_path / "j.json").read_text()


@pytest.mark.parametrize("variant,n,n_devices,c_x,c_omega", [
    ("cov", 128, 1, 1, 1), ("cov", None, 1, 1, 1), ("obs", 128, 1, 1, 1),
    ("cov", 4096, 8, 2, 2), ("obs", 256, 8, 1, 4)])
def test_record_solve_cost_equals_the_reference(variant, n, n_devices, c_x,
                                                c_omega):
    """Flops and words from the port's cost model (H100 constants) equal
    the reference's (EDISON): they do not depend on the machine."""
    kw = dict(variant=variant, p=64, n=n, iters=10, ls_total=14,
              density=0.2, n_devices=n_devices, c_x=c_x, c_omega=c_omega,
              wall_s=0.05)
    reg, jreg = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    out = tmetrics.record_solve_cost(reg, **kw)
    want = jmetrics.record_solve_cost(jreg, **kw)
    assert out == want and out["flops"] > 0 and out["words"] >= 0
    assert reg.snapshot() == jreg.snapshot()
    assert reg.counter("repro_solves_total", variant=variant).value == 1
    assert reg.counter("repro_solve_iters_total",
                       variant=variant).value == 10


# ---------------------------------------------------------------------------
# estimator integration
# ---------------------------------------------------------------------------

KERNEL_KNOBS = dict(use_pallas=True, sparse_matmul="on", sparse_block=8,
                    sparse_threshold=0.5)


def _fit(obs, variant="cov", **cfg_overrides):
    prob = graphs.make_problem("chain", 24, 64, seed=0)
    cfg = dict(backend="reference", variant=variant, tol=1e-5,
               max_iters=60, obs=obs, device="cpu")
    cfg.update(cfg_overrides)
    est = test_.ConcordEstimator(lam1=0.2, lam2=0.05,
                                 config=test_.SolverConfig(**cfg))
    if variant == "cov":
        est.fit_cov(np.asarray(prob.s, np.float64), n_samples=64)
    else:
        est.fit(np.asarray(prob.x, np.float64))
    return est.report_


@pytest.mark.parametrize("knobs", [{}, KERNEL_KNOBS],
                         ids=["dense", "kernels-sparse"])
@pytest.mark.parametrize("variant", ["cov", "obs"])
def test_obs_levels_are_bit_exact_and_carry_telemetry(variant, knobs):
    base = _fit("off", variant, **knobs)
    assert base.telemetry is None
    for obs in ("summary", "trace"):
        rep = _fit(obs, variant, **knobs)
        assert torch.equal(rep.omega, base.omega), obs
        assert (rep.iters, rep.ls_total, rep.converged, rep.stalled) == \
            (base.iters, base.ls_total, base.converged, base.stalled)
        tele = rep.telemetry
        assert tele["obs"] == obs
        assert tele["flops"] > 0 and tele["words"] >= 0
        assert tele["dispatch_s"] >= 0 and tele["execute_s"] >= 0
        assert tele["ls_per_iter"] == rep.ls_total / rep.iters
        assert "_pending_cost" not in tele


def test_telemetry_costs_equal_the_reference(x64):
    """The telemetry's flops and words, fed from the report's own nnz
    count, equal the reference facade's at the same f64 solve."""
    from repro import estimator as jest
    prob = graphs.make_problem("chain", 24, 64, seed=0)
    s = np.asarray(prob.s, np.float64)
    cfg = dict(backend="reference", variant="cov", tol=1e-5, max_iters=60,
               obs="summary")
    jrep = jest.ConcordEstimator(lam1=0.2, lam2=0.05, config=jest.SolverConfig(
        **cfg)).fit_cov(s, n_samples=64).report_
    rep = _fit("summary")
    assert (rep.iters, rep.ls_total) == (jrep.iters, jrep.ls_total)
    assert rep.nnz_per_row == jrep.nnz_per_row
    assert (rep.telemetry["flops"], rep.telemetry["words"]) == \
        (jrep.telemetry["flops"], jrep.telemetry["words"])


def test_obs_trace_adds_no_kernel_call(monkeypatch):
    """The counterpart of the reference's zero-extra-compiles check: a
    traced solve calls the kernel wrappers exactly as often as an
    untraced one (the tracer does no device work of its own)."""
    from repro_torch.kernels import ops
    calls = {}
    for name in ("fused_prox_stats", "fused_prox_trial", "masked_matmul"):
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    counts = {}
    for obs in ("off", "trace", "summary"):
        calls.clear()
        _fit(obs, **KERNEL_KNOBS)
        counts[obs] = dict(calls)
    # the sparse l1 trial is kernel 1's trial entry
    assert counts["off"]["fused_prox_trial"] > 0
    assert counts["trace"] == counts["summary"] == counts["off"]


def test_obs_config_validation():
    with pytest.raises(ValueError, match="obs"):
        test_.SolverConfig(obs="verbose")
    for obs in ("off", "summary", "trace"):
        assert test_.SolverConfig(obs=obs).obs == obs


def test_obs_off_never_imports_the_obs_package():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from repro_torch.core import graphs\n"
        "from repro_torch.estimator import ConcordEstimator, SolverConfig\n"
        "from repro_torch.data import compute_gram\n"
        "prob = graphs.make_problem('chain', 16, 40, seed=0)\n"
        "cfg = SolverConfig(backend='reference', variant='cov', tol=1e-4,\n"
        "                   max_iters=40, obs='off', device='cpu')\n"
        "est = ConcordEstimator(lam1=0.2, config=cfg)\n"
        "est.fit_cov(np.asarray(prob.s, np.float64))\n"
        "est.fit_path(s=np.asarray(prob.s, np.float64), n_samples=40,\n"
        "             lam1_grid=[0.3, 0.2])\n"
        "compute_gram(np.asarray(prob.x, np.float64), device='cpu')\n"
        "loaded = [m for m in sys.modules\n"
        "          if m.startswith('repro_torch.obs')]\n"
        "assert not loaded, f\"obs='off' pulled in {loaded}\"\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_fit_path_telemetry_and_span():
    tracer = ttrace.get_tracer()
    tracer.clear()
    prob = graphs.make_problem("chain", 20, 48, seed=0)
    cfg = test_.SolverConfig(backend="reference", variant="cov", tol=1e-4,
                             max_iters=60, obs="summary", device="cpu")
    est = test_.ConcordEstimator(penalty="l1", config=cfg)
    path = est.fit_path(s=np.asarray(prob.s, np.float64),
                        lam1_grid=[0.3, 0.2, 0.1], n_samples=48,
                        score_bic=False)
    tele = path.telemetry
    assert set(tele) >= {"lam1", "iters", "ls_total", "converged",
                         "objective", "wall_time_s"}
    assert all(len(v) == 3 for v in tele.values())
    assert np.all(tele["iters"] >= 1)
    spans = tracer.snapshot()
    names = [s.name for s in spans]
    assert "fit_path" in names and names.count("fit.reference") == 3
    fp = next(s for s in spans if s.name == "fit_path")
    assert fp.args == {"points": 3, "mode": "sequential",
                       "total_iters": path.total_iters}
    assert tracer.mode == "off"


def _batched_path(pkg, obs, s):
    cfg = pkg.SolverConfig(backend="reference", variant="cov", tol=1e-5,
                           max_iters=80, obs=obs,
                           **({"device": "cpu"} if pkg is test_ else {}))
    est = pkg.ConcordEstimator(penalty="l1", config=cfg)
    return est.fit_path(s=s, lam1_grid=[0.4, 0.3, 0.2], n_samples=80,
                        mode="batched", score_bic=False)


def _batch_records(tracer):
    return [(s.name, s.phase, s.args) for s in tracer.snapshot()
            if s.cat == "batch"]


def test_batched_path_wave_and_segment_records_match_the_reference(x64):
    """The batched engine's ``batch.wave`` events and ``batch.segment``
    spans under ``obs="trace"``: the same names, order and attributes as
    the reference's trace of the same f64 path; ``obs="off"`` is
    bit-identical, with the same iteration counts and kernel launches."""
    from repro import estimator as jest
    from repro_torch.kernels import ops
    s = np.asarray(graphs.make_problem("chain", 24, 80, seed=0).s,
                   np.float64)
    jtr, ttr = jtrace.get_tracer(), ttrace.get_tracer()
    jtr.clear()
    ttr.clear()
    _batched_path(jest, "trace", s)
    ops.reset_launches()
    traced = _batched_path(test_, "trace", s)
    traced_launches = dict(ops.LAUNCHES)
    want, got = _batch_records(jtr), _batch_records(ttr)
    assert [r[0] for r in want].count("batch.wave") >= 1
    assert [r[0] for r in want].count("batch.segment") >= 1
    assert got == want
    for name, phase, args in got:
        keys = ({"wave", "lanes"} if name == "batch.wave"
                else {"segment", "wave", "lanes", "cap"})
        assert set(args) == keys, (name, args)
    ttr.clear()
    ops.reset_launches()
    off = _batched_path(test_, "off", s)
    assert dict(ops.LAUNCHES) == traced_launches
    assert len(ttr) == 0
    for a, b in zip(off.reports, traced.reports):
        assert torch.equal(a.omega, b.omega)
        assert (a.iters, a.ls_total) == (b.iters, b.ls_total)


def test_gram_chunk_spans_only_when_traced():
    from repro_torch.data import compute_gram
    x = np.random.default_rng(0).standard_normal((90, 6))
    tracer = ttrace.get_tracer()
    tracer.clear()
    compute_gram(x, chunk_rows=30, device="cpu")
    assert len(tracer) == 0
    with tracer.scoped("trace"):
        g = compute_gram(x, chunk_rows=30, device="cpu")
    spans = [s for s in tracer.snapshot() if s.name == "gram.chunk"]
    assert g.n_chunks == 3 and len(spans) == 3
    assert [s.args for s in spans] == [
        {"chunk": i, "rows": 30, "p": 6} for i in range(3)]
    assert {(s.cat, s.level) for s in spans} == {("data", "trace")}


# ---------------------------------------------------------------------------
# comm reconciliation: measured == predicted, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,P,cx,co,iters,ls_total", [
    ("cov", 1, 1, 1, 5, 11), ("cov", 4, 1, 1, 6, 13),
    ("cov", 4, 2, 2, 6, 13), ("obs", 4, 1, 1, 6, 13),
    ("obs", 4, 1, 2, 6, 13), ("obs", 8, 2, 2, 9, 40),
    ("cov", 8, 2, 2, 3, 3)])
def test_predict_schedule_against_the_reference(variant, P, cx, co, iters,
                                                ls_total):
    """Every row equals the reference's prediction in count and exact
    bytes, except the scalar psum row: one stacked objective psum (3
    elements, the bytes of 3 scalars) for the reference's three, and one
    norm psum per iteration for its two (the port reuses the accepted
    trial's <D, D>)."""
    kw = dict(p_pad=32, n=48, iters=iters, ls_total=ls_total)
    got = twatch.predict_schedule(variant, grid=Grid1p5D(P, cx, co), **kw)
    want = jwatch.predict_schedule(variant, grid=JGrid(P, cx, co), **kw)
    scalar = ("psum", ("i", "j") if variant == "cov" else ("i", "k"))
    assert set(got) == set(want)
    for key in want:
        if key == scalar:
            continue
        assert got[key] == want[key], key
    extent = (P // (cx * co)) * (co if variant == "cov" else cx)
    one = collective_wire_bytes("psum", 8, extent)
    assert got[scalar]["count"] == \
        want[scalar]["count"] - 2 * (1 + ls_total) - iters
    assert got[scalar]["bytes"] == want[scalar]["bytes"] - iters * one


def test_predict_schedule_refusals():
    with pytest.raises(twatch.ReconcileError, match="sample count"):
        twatch.predict_schedule("obs", p_pad=8, n=None, grid=Grid1p5D(1, 1, 1),
                                iters=1, ls_total=1)
    with pytest.raises(twatch.ReconcileError, match="unknown variant"):
        twatch.predict_schedule("xx", p_pad=8, n=4, grid=Grid1p5D(1, 1, 1),
                                iters=1, ls_total=1)


@pytest.mark.parametrize("variant", ["cov", "obs"])
def test_commwatch_reconciles_single_process_exactly(variant):
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((40, 24)))
    data = x if variant == "obs" else x.T @ x / 40
    fit = tdist.fit_cov if variant == "cov" else tdist.fit_obs
    with twatch.CommWatch() as watch:
        res = fit(data, 0.3, grid=Grid1p5D(1, 1, 1), max_iters=5)
    reports = watch.reconcile()
    assert len(reports) == 1
    rep = reports[0]
    assert rep.ok, rep.render()
    assert (rep.iters, rep.ls_total) == (res.iters, res.ls_total)
    assert rep.rows
    for r in rep.rows:
        assert r.measured_count == r.predicted_count > 0
    assert "EXACT MATCH" in rep.render()
    js = rep.to_json()
    assert js["ok"] and len(js["rows"]) == len(rep.rows)
    # uninstalled: later solves are not watched
    fit(data, 0.3, grid=Grid1p5D(1, 1, 1), max_iters=2)
    assert len(watch.records) == 1


def test_commwatch_refuses_sparse_and_unfinished_solves():
    from repro_torch.core import matops
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((40, 16)))
    with twatch.CommWatch() as watch:
        tdist.fit_cov(x.T @ x / 40, 0.3, grid=Grid1p5D(1, 1, 1), max_iters=3,
                      sparse_matmul=matops.MatmulPolicy("on", 4, 0.5))
    with pytest.raises(twatch.ReconcileError, match="block-sparse"):
        watch.reconcile()
    watch.clear()
    watch.on_dispatch("cov", Grid1p5D(1, 1, 1), {"p_pad": 8})
    with pytest.raises(twatch.ReconcileError, match="never arrived"):
        watch.reconcile()


def test_a_divergence_is_reported():
    """One collective too many in the window is a MISMATCH row."""
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((40, 16)))
    with twatch.CommWatch() as watch:
        tdist.fit_cov(x.T @ x / 40, 0.3, grid=Grid1p5D(1, 1, 1), max_iters=3)
    rec = watch.records[0]
    watch._open = rec
    watch.on_collective("psum", ("i", "j"), Fraction(0))
    watch._open = None
    rep = watch.reconcile()[0]
    assert not rep.ok and "DIVERGENCE" in rep.render()
    bad = [r for r in rep.rows if not r.match]
    assert [(r.prim, r.axes) for r in bad] == [("psum", ("i", "j"))]
    assert bad[0].measured_count == bad[0].predicted_count + 1


@pytest.mark.parametrize("variant,cx,co", GRIDS_4,
                         ids=[f"{v}-4-{a}-{b}" for v, a, b in GRIDS_4])
def test_reconcile_4_ranks_measured_equals_predicted(pool, variant, cx, co):
    """On 4 gloo ranks, every rank's posted collectives equal the
    prediction exactly, per (prim, axes), count and bytes."""
    x = np.random.default_rng(0).standard_normal((48, 32))
    out = pool.run(reconcile, 4, cx, co, variant, x, 6)
    for rank, reports in enumerate(out):
        assert len(reports) == 1, rank
        rep = reports[0]
        assert rep["ok"], (rank, rep)
        for row in rep["rows"]:
            assert row["match"] and row["measured_count"] > 0, (rank, row)
        assert Fraction(rep["measured_bytes_total"]) == \
            Fraction(rep["predicted_bytes_total"]) > 0
    assert len({(r[0]["iters"], r[0]["ls_total"]) for r in out}) == 1


@pytest.mark.parametrize("world", [1, 4])
def test_estimator_trace_mode_reconciles(pool, world):
    """Through the facade's distributed backend at ``obs="trace"``: the
    reconciliation lands on every rank's telemetry, every row exact."""
    prob = graphs.make_problem("chain", 24, 56, seed=0)
    x = np.asarray(prob.x, np.float64)
    kw = dict(variant="cov", tol=1e-4, max_iters=8, obs="trace")
    if world == 1:
        cfg = test_.SolverConfig(backend="distributed", device="cpu", **kw)
        rep = test_.ConcordEstimator(lam1=0.25, lam2=0.05,
                                     config=cfg).fit(x).report_
        teles = [rep.telemetry]
    else:
        teles = [r["telemetry"] for r in
                 pool.run(facade, x, 0.25, "distributed", kw)]
    for tele in teles:
        assert tele is not None and tele["comm_reconcile_ok"] is True
        reps = tele["comm_reconcile"]
        assert len(reps) == 1 and reps[0]["n_devices"] == world
        assert all(row["match"] for row in reps[0]["rows"])
        assert "dispatch_s" in tele and "flops" in tele
    if world == 4:
        assert all(Fraction(t["comm_reconcile"][0]["measured_bytes_total"])
                   > 0 for t in teles)


def test_summary_and_sparse_trace_do_not_reconcile():
    """Only ``obs="trace"`` on the dense path arms the watcher."""
    prob = graphs.make_problem("chain", 16, 40, seed=0)
    x = np.asarray(prob.x, np.float64)
    for obs, knobs in (("summary", {}), ("trace", KERNEL_KNOBS)):
        cfg = test_.SolverConfig(backend="distributed", variant="cov",
                                 obs=obs, device="cpu", **knobs)
        tele = test_.ConcordEstimator(lam1=0.3, config=cfg).fit(
            x).report_.telemetry
        assert tele["obs"] == obs and "comm_reconcile" not in tele


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _traces(tmp_path):
    """A Chrome trace from the port and a JSONL trace from the reference."""
    a, b = _record(ttrace), _record(jtrace)
    with b.span("extra"):
        pass
    a.export_chrome(tmp_path / "a.json")
    b.export_jsonl(tmp_path / "b.jsonl")
    return tmp_path / "a.json", tmp_path / "b.jsonl"


def test_cli_print(tmp_path, capsys):
    a, b = _traces(tmp_path)
    for path in (a, b):
        assert tcli.main(["print", str(path)]) == 0
        out = capsys.readouterr().out
        assert "events" in out and "solve" in out and "by name:" in out


def test_cli_diff(tmp_path, capsys):
    a, b = _traces(tmp_path)
    assert tcli.main(["diff", str(a), str(b)]) == 0
    out = capsys.readouterr().out
    assert "extra" in out and "0 -> 1" in out and "1 -> 1" in out


def test_cli_export_round_trips_across_formats(tmp_path):
    a, b = _traces(tmp_path)
    out = tmp_path / "c.jsonl"
    assert tcli.main(["export", str(a), str(out)]) == 0
    back = jtrace.load_jsonl(out)
    assert sorted(s.name for s in back) == ["mark", "solve"]
    out2 = tmp_path / "d.json"
    assert tcli.main(["export", str(b), str(out2)]) == 0
    assert sorted(s.name for s in jtrace.load_chrome(out2)) == \
        ["extra", "mark", "solve"]


def test_cli_reconcile_single_process(tmp_path, capsys):
    tj, js = tmp_path / "t.json", tmp_path / "r.json"
    rc = tcli.main(["reconcile", "--trace-out", str(tj), "--json-out",
                    str(js)], device="cpu")
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "OK: measured == predicted" in out and "EXACT MATCH" in out
    rows = json.loads(js.read_text())
    assert [r["variant"] for r in rows] == ["cov", "obs"]
    assert all(r["ok"] for r in rows)
    names = {s.name for s in ttrace.load_chrome(tj)}
    assert {"reconcile.cov", "reconcile.obs"} <= names


def test_cli_reconcile_on_4_ranks(pool):
    codes = pool.run(obs_cli, ["reconcile", "--c-x", "2", "--c-omega", "2",
                               "--variants", "cov"])
    assert codes == [0, 0, 0, 0]
    codes = pool.run(obs_cli, ["reconcile", "--c-omega", "2", "--variants",
                               "obs", "--max-iters", "4"])
    assert codes == [0, 0, 0, 0]
