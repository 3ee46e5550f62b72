"""The port's spans and run census (``repro_torch.census``) on the CPU:
the host syncs a solve counts, the census's reset, the ``repro.*``
profiler ranges and the tracer's spans on the profiler's clock, and
estimates that no span, profiler or obs level moves."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import census
from repro_torch import estimator as est_
from repro_torch.core import graphs, prox
from repro_torch.kernels import ops
from repro_torch.obs import trace as ttrace

REPO = Path(__file__).resolve().parents[1]

#: lam1 of the path, and of the batch's four lanes
GRID = [0.3, 0.2, 0.15]
LAM1S = [0.3, 0.25, 0.2, 0.12]


@pytest.fixture(autouse=True)
def _quiet_tracer():
    """The tracer is process-global: leave it off and empty."""
    yield
    if ttrace._TRACER is not None:
        ttrace._TRACER.set_mode("off")
        ttrace._TRACER.clear()


def _config(obs="off", **kw):
    base = dict(backend="reference", variant="cov", tol=1e-5, max_iters=80,
                obs=obs, device="cpu", use_pallas=True, sparse_matmul="on",
                sparse_block=4, sparse_threshold=0.5)
    return est_.SolverConfig(**{**base, **kw})


def _s():
    return np.asarray(graphs.make_problem("chain", 24, 80, seed=0).s,
                      np.float64)


def _xs():
    return np.stack([np.asarray(graphs.make_problem(
        "chain", 16, 48, seed=k).x, np.float64) for k in range(4)])


def _path(obs="off"):
    est = est_.ConcordEstimator(penalty="l1", config=_config(obs))
    return est.fit_path(s=_s(), lam1_grid=GRID, n_samples=80)


def _batch(obs="off"):
    # chunk 2: segments end often, so lanes are harvested and repacked
    return est_.fit_batch(x=_xs(), lam1=LAM1S, lam2=0.05,
                          config=_config(obs, variant="obs", batch_chunk=2))


def _ranges(prof) -> dict:
    """Start (ns) of every ``repro.*`` range in the profile, by name."""
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(census.RANGE_PREFIX):
            out.setdefault(e.name(), []).append(e.start_ns())
    return {k: sorted(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# the census
# ---------------------------------------------------------------------------

def test_sparse_solve_counts_two_syncs_per_trial():
    """The analysis entry's block-sparse solve: each trial reads the
    candidate's occupied-block count and then its acceptance and step
    norms; the solve adds the first product's count, the final density
    and the final objective."""
    spec = prox._analysis_solve_sparse("cpu")
    ops.reset_launches()
    res = spec["fn"](*spec["args"], **spec["kwargs"])
    trials = res.ls_total
    assert trials > 0
    c = census.CENSUS
    assert c.syncs == {"core/prox.py:prox_gradient": trials + 2,
                       "core/matops.py:occupied_blocks": trials + 1}
    assert sum(c.syncs.values()) == 2 * trials + 3
    assert c.spans["ls_trial"] == trials
    assert c.spans["prox.fused_trial"] == trials
    assert c.spans[census.HOST_SYNC] == 2 * trials + 3
    assert (c.spans.get("matmul.sparse", 0)
            + c.spans.get("matmul.dense", 0)) == trials + 1
    # nothing recorded, so nothing was timed
    assert c.span_s == {} and c.sync_s == {}


@pytest.mark.parametrize("backend,penalty,fused", [
    ("reference", "l1", True),
    ("reference", "scad", False),
    ("distributed", "l1", False),
])
def test_fused_trial_span_counts_its_trials(backend, penalty, fused):
    """The sequential loop's sparse trial opens ``prox.fused_trial`` once
    a trial on the kernel prox; SCAD (no kernel prox: the plain trial)
    and the distributed solve (its own ops) open none.  Either way a
    trial reads the host twice."""
    ops.reset_launches()
    est = est_.ConcordEstimator(lam1=0.3, lam2=0.05, penalty=penalty,
                                config=_config(backend=backend))
    trials = est.fit_cov(_s(), n_samples=80).report_.ls_total
    c = census.CENSUS
    assert trials > 0 and c.spans["ls_trial"] == trials
    assert c.spans.get("prox.fused_trial", 0) == (trials if fused else 0)
    if backend == "reference":
        assert c.syncs["core/prox.py:prox_gradient"] == trials + 2
        assert c.syncs["core/matops.py:occupied_blocks"] == trials + 1


def test_reset_launches_zeroes_the_census():
    _path()
    c = census.CENSUS
    assert c.spans and c.syncs
    with profile(activities=[ProfilerActivity.CPU]):
        _path()
    assert c.span_s and c.sync_s
    ops.reset_launches()
    assert c.spans == c.syncs == c.span_s == c.sync_s == {}
    assert set(ops.LAUNCHES.values()) == {0}


def test_path_counts_every_read_of_its_points():
    """Per point: two reads a trial, three a solve, the report's scan, the
    BIC product's occupied-block count and the BIC's one read; per path:
    the input's finiteness and symmetry."""
    ops.reset_launches()
    path = _path()
    c = census.CENSUS
    trials, points = path.total_ls, len(path)
    assert sum(c.syncs.values()) == 2 * trials + 6 * points + 2
    assert c.syncs["estimator/report.py:pseudo_bic"] == points
    assert c.syncs["core/matops.py:occupied_blocks"] == (
        trials + 2 * points)
    assert c.syncs["estimator/backends.py:_report"] == points
    assert c.spans["bic"] == c.spans["fit.report"] == points
    assert c.spans["fit_path"] == 1
    # one dispatch a trial, one to start each solve and one a BIC
    assert (c.spans.get("matmul.sparse", 0)
            + c.spans.get("matmul.dense", 0)) == trials + 2 * points


def test_flat_steps_match_the_engine_stats():
    ops.reset_launches()
    rep = _batch()
    c = census.CENSUS
    steps = len(rep.stats.capacities)
    assert steps > 0 and rep.stats.segments > 1
    assert c.spans["batch.flat_step"] == steps
    assert c.syncs["core/batch.py:_apply_trial"] == steps
    assert c.spans["batch.segment"] == rep.stats.segments
    assert c.spans["batch.harvest"] == rep.stats.segments
    assert c.spans["batch.repack"] == rep.stats.segments - rep.stats.waves
    assert c.spans["fit_batch"] == 1


# ---------------------------------------------------------------------------
# profiler ranges and the tracer's clock
# ---------------------------------------------------------------------------

PATH_RANGES = {"fit_path", "fit.reference", "dispatch", "execute",
               "ls_trial", "host_sync", "fit.report", "bic"}
BATCH_RANGES = {"fit_batch", "batch.segment", "batch.flat_step",
                "batch.accept", "batch.harvest", "batch.repack",
                "host_sync", "fit.report"}


@pytest.mark.parametrize("run,names", [(_path, PATH_RANGES),
                                       (_batch, BATCH_RANGES)],
                         ids=["fit_path", "fit_batch"])
def test_profiler_shows_the_program_ranges(run, names):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    got = _ranges(prof)
    assert {census.RANGE_PREFIX + n for n in names} <= set(got)
    ops.reset_launches()
    run()
    # one range per span the census counts (the matmul branches too)
    assert {"matmul.sparse", "matmul.dense"} & set(census.CENSUS.spans) \
        or run is _batch
    for name, count in census.CENSUS.spans.items():
        assert len(got[census.RANGE_PREFIX + name]) == count, name


@pytest.mark.parametrize("run", [_path, _batch],
                         ids=["fit_path", "fit_batch"])
def test_chrome_export_lies_on_the_profiler_clock(run, tmp_path):
    """At obs="trace" under the profiler the spans of the Chrome export
    start within 1 ms of their ``repro.*`` ranges (tens of microseconds
    apart, unless the host stalls between the two clock reads; the input
    checks before the call scopes the tracer have a range and no
    span)."""
    ttrace.get_tracer().clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run("trace")
    ranges = _ranges(prof)
    out = tmp_path / "trace.json"
    ttrace.get_tracer().export_chrome(out)
    spans: dict = {}
    for ev in json.loads(out.read_text())["traceEvents"]:
        if ev["ph"] == "X":
            spans.setdefault(ev["name"], []).append(ev["ts"])
    assert {"fit_batch" if run is _batch else "fit_path",
            census.HOST_SYNC} <= set(spans)
    every = []
    for name, starts in spans.items():
        us = np.asarray(ranges[census.RANGE_PREFIX + name]) / 1e3
        assert len(us) >= len(starts), name
        gaps = np.abs(us[None, :] - np.asarray(starts)[:, None]).min(axis=1)
        assert np.median(gaps) < 1e3, (name, np.median(gaps))
        every.extend(gaps)
    assert np.mean(np.asarray(every) < 1e3) > 0.95


def test_tracer_stamps_the_epoch_clock():
    import time
    t = ttrace.Tracer(mode="summary")
    before = time.time()
    with t.span("solve"):
        pass
    t.event("mark")
    after = time.time()
    for s in t.snapshot():
        assert before - 1e-3 <= s.t_start <= after + 1e-3


def test_fit_batch_honours_obs():
    tracer = ttrace.get_tracer()
    tracer.clear()
    rep = _batch("trace")
    spans = tracer.snapshot()
    names = [s.name for s in spans]
    assert names.count("fit_batch") == 1
    assert names.count("batch.segment") == rep.stats.segments
    fb = next(s for s in spans if s.name == "fit_batch")
    assert fb.args == {"lanes": 4, "flat_steps": len(rep.stats.capacities),
                       "segments": rep.stats.segments}
    assert tracer.mode == "off"
    tracer.clear()
    _batch("summary")
    assert [s.name for s in tracer.snapshot()].count("fit_batch") == 1
    assert "batch.segment" not in [s.name for s in tracer.snapshot()]


def test_batched_path_honours_obs():
    tracer = ttrace.get_tracer()
    tracer.clear()
    est = est_.ConcordEstimator(penalty="l1", config=_config("trace"))
    path = est.fit_path(s=_s(), lam1_grid=GRID, n_samples=80,
                        mode="batched")
    names = [s.name for s in tracer.snapshot()]
    assert names.count("fit_batch") == 1 and names.count("fit_path") == 1
    assert names.count("batch.segment") == path.batch_stats.segments


# ---------------------------------------------------------------------------
# nothing moves the estimate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def baseline():
    return _path(), _batch()


def _same(a, b):
    for x, y in zip(a.reports, b.reports):
        assert torch.equal(x.omega, y.omega)
        assert (x.iters, x.ls_total) == (y.iters, y.ls_total)
        assert x.bic == y.bic


@pytest.mark.parametrize("obs", ["off", "summary", "trace"])
@pytest.mark.parametrize("profiled", [False, True],
                         ids=["no-profiler", "profiler"])
def test_estimates_bit_identical(baseline, obs, profiled):
    ops.reset_launches()
    want = dict(ops.LAUNCHES)
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            path, batch = _path(obs), _batch(obs)
    else:
        path, batch = _path(obs), _batch(obs)
    _same(path, baseline[0])
    _same(batch, baseline[1])
    assert dict(ops.LAUNCHES) == want


def test_obs_off_under_the_profiler_never_imports_the_obs_package():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from torch.profiler import ProfilerActivity, profile\n"
        "from repro_torch.core import graphs\n"
        "from repro_torch.estimator import ConcordEstimator, SolverConfig,"
        " fit_batch\n"
        "s = np.asarray(graphs.make_problem('chain', 16, 40, seed=0).s)\n"
        "x = np.stack([np.asarray(graphs.make_problem('chain', 12, 30,\n"
        "              seed=k).x) for k in range(2)])\n"
        "cfg = SolverConfig(backend='reference', variant='cov', tol=1e-4,\n"
        "                   max_iters=40, obs='off', device='cpu')\n"
        "with profile(activities=[ProfilerActivity.CPU]):\n"
        "    ConcordEstimator(lam1=0.2, config=cfg).fit_path(\n"
        "        s=s, n_samples=40, lam1_grid=[0.3, 0.2])\n"
        "    fit_batch(x=x, lam1=[0.3, 0.2], config=cfg.replace(\n"
        "        variant='obs'))\n"
        "loaded = [m for m in sys.modules\n"
        "          if m.startswith('repro_torch.obs')]\n"
        "assert not loaded, f\"obs='off' pulled in {loaded}\"\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
