"""The port's streaming data/Gram subsystem (``repro_torch.data``) against
the JAX package's (``repro.data``) on the CPU, in float64: the streamed
Gram under every transform and chunking, the panel product, the rank
transform, shard files across packages, the scenario families, the
facade's streaming entry points and the chunk-size guidance.  Mirrors
``tests/test_data.py``."""
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro import estimator as jest
from repro.core import costmodel as jcost
from repro.core.matops import panel_gram as jpanel_gram
from repro.data import transforms as jtf
from repro.data.shards import is_streaming_input as j_is_streaming
from repro_torch import convert
from repro_torch import data as tdata
from repro_torch import estimator as test_
from repro_torch.core import costmodel as tcost
from repro_torch.core.matops import panel_gram as tpanel_gram
from repro_torch.data import gram as tgram
from repro_torch.data import transforms as ttf
from repro_torch.data.shards import is_streaming_input as t_is_streaming

from _torch_parity import x64  # noqa: F401

#: the reference's own bar for a streamed Gram (tests/test_data.py)
AGREE = 1e-10
#: scenario Omega and stream chunks, rank scores: rounding of one solve
#: or one ndtri, far below any statistic built from them
EXACT = 1e-12

MOMENT_TRANSFORMS = ["none", "center", "standardize"]
FAMILIES = ["banded", "block", "erdos_renyi", "hub", "scale_free"]

#: facade parity: the kernel paths and the sparse branch on the CPU
KNOBS = dict(backend="reference", variant="cov", tol=1e-5, max_iters=200,
             use_pallas=True, sparse_matmul="on", sparse_block=8,
             sparse_threshold=0.5)


@pytest.fixture(scope="module")
def x_data():
    rng = np.random.default_rng(7)
    return rng.standard_normal((900, 41))


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _dense_reference(x, transform):
    x = np.asarray(x, np.float64)
    if transform == "none":
        z = x
    elif transform == "center":
        z = x - x.mean(0)
    elif transform == "standardize":
        z = (x - x.mean(0)) / x.std(0)
    else:  # rank
        z = np.stack([jtf.rank_transform_column(x[:, j])
                      for j in range(x.shape[1])], axis=1)
    return z.T @ z / x.shape[0]


def _assert_gram_pair(got, want, atol=AGREE):
    """A port GramResult against a reference one."""
    assert (got.n, got.p, got.transform, got.n_chunks, got.source_dtype) \
        == (want.n, want.p, want.transform, want.n_chunks, want.source_dtype)
    assert got.s.dtype == torch.float64
    np.testing.assert_allclose(_np(got.s), np.asarray(want.s), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(_np(got.mean), want.mean, rtol=0, atol=EXACT)
    np.testing.assert_allclose(_np(got.var), want.var, rtol=0, atol=EXACT)


# ---------------------------------------------------------------------------
# streamed Gram against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk_rows", [97, 211, 900])
@pytest.mark.parametrize("transform", MOMENT_TRANSFORMS + ["rank"])
def test_streamed_gram_matches_reference(x64, x_data, transform,
                                         chunk_rows):
    got = tdata.compute_gram(x_data, transform=transform,
                             chunk_rows=chunk_rows, device="cpu")
    want = jdata.compute_gram(x_data, transform=transform,
                              chunk_rows=chunk_rows)
    _assert_gram_pair(got, want)
    s = _np(got.s)
    assert np.abs(s - _dense_reference(x_data, transform)).max() < AGREE
    np.testing.assert_array_equal(s, s.T)
    assert got.to_meta().keys() == want.to_meta().keys()
    assert got.to_meta()["diag_mean"] == pytest.approx(
        want.to_meta()["diag_mean"], abs=EXACT)


def test_f32_chunks_give_an_f64_gram(x64, x_data):
    x32 = x_data.astype(np.float32)
    got = tdata.compute_gram(tdata.as_source(x32, chunk_rows=180),
                             device="cpu")
    want = jdata.compute_gram(jdata.as_source(x32, chunk_rows=180))
    assert got.s.dtype == torch.float64 and got.source_dtype == "float32"
    up = x32.astype(np.float64)
    assert np.abs(_np(got.s) - up.T @ up / 900).max() < AGREE
    _assert_gram_pair(got, want)


def test_tensor_chunks_stream_like_arrays(x_data):
    chunks = [x_data[lo:lo + 300] for lo in range(0, 900, 300)]
    want = tdata.compute_gram(chunks, transform="center", device="cpu")
    for data in ([torch.from_numpy(c) for c in chunks],
                 (torch.from_numpy(c).float() for c in chunks),
                 torch.from_numpy(x_data)):
        got = tdata.compute_gram(data, transform="center", chunk_rows=300,
                                 device="cpu")
        # float32 chunks: the Gram of the upcast f32 values
        tol = 1e-6 if got.source_dtype == "float32" else AGREE
        assert np.abs(_np(got.s) - _np(want.s)).max() < tol
    # a tensor chunk the caller owns is never centered in place
    t = torch.from_numpy(x_data.copy())
    tdata.GramAccumulator(device="cpu").update(t)
    np.testing.assert_array_equal(t.numpy(), x_data)


def test_chunk_order_invariance(x_data):
    chunks = [x_data[lo:lo + 225] for lo in range(0, 900, 225)]
    g1 = tdata.compute_gram(chunks, transform="standardize", device="cpu")
    g2 = tdata.compute_gram(chunks[::-1], transform="standardize",
                            device="cpu")
    assert np.abs(_np(g1.s) - _np(g2.s)).max() < EXACT


def test_accumulator_merge_matches_single_pass(x64, x_data):
    def halves(new):
        a = new().update(x_data[:300]).update(x_data[300:400])
        b = new().update(x_data[400:850]).update(x_data[850:])
        return a.merge(b).finalize()
    merged = halves(lambda: tdata.GramAccumulator(device="cpu"))
    one = tdata.compute_gram(x_data, device="cpu")
    assert merged.n == 900 and merged.n_chunks == 4
    assert np.abs(_np(merged.s) - _np(one.s)).max() < AGREE
    assert np.abs(_np(merged.mean) - _np(one.mean)).max() < EXACT
    _assert_gram_pair(merged, halves(jdata.GramAccumulator))


@pytest.mark.parametrize("panel", [1, 7, 41, 512])
def test_panel_gram_matches_reference_and_direct(x64, x_data, panel):
    x = torch.from_numpy(x_data)
    got = tpanel_gram(x, panel=panel)
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - np.asarray(jpanel_gram(x_data, panel=panel))
                  ).max() < AGREE
    assert np.abs(got.numpy() - x_data.T @ x_data).max() < AGREE
    # with out=, the slabs add in place into the caller's accumulator
    acc = torch.zeros((41, 41), dtype=torch.float64)
    assert tpanel_gram(x, panel=panel, out=acc) is acc
    tpanel_gram(x, panel=panel, out=acc)
    assert np.abs(acc.numpy() - 2 * x_data.T @ x_data).max() < AGREE


def test_panel_gram_rejects_bad_shapes(x_data):
    x = torch.from_numpy(x_data)
    with pytest.raises(ValueError, match="panel"):
        tpanel_gram(x, panel=0)
    with pytest.raises(ValueError, match="2-D"):
        tpanel_gram(x[0])
    with pytest.raises(ValueError, match="out"):
        tpanel_gram(x, out=torch.zeros((3, 3), dtype=torch.float64))


@pytest.mark.parametrize("block", [1, 7, 41, 4096])
def test_in_place_symmetrize_is_the_one_shot_formula(block):
    s = torch.from_numpy(np.random.default_rng(1).standard_normal((41, 41)))
    want = 0.5 * (s + s.T)
    np.testing.assert_array_equal(
        tgram._symmetrize_(s.clone(), block=block).numpy(), want.numpy())


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def test_standardize_gram_is_correlation(x_data):
    g = tdata.compute_gram(x_data, transform="standardize", device="cpu")
    assert np.abs(np.diag(_np(g.s)) - 1.0).max() < EXACT
    assert np.abs(_np(g.s)).max() <= 1.0 + EXACT


def test_rank_transform_invariant_under_monotone_marginals(x_data):
    distorted = x_data.copy()
    distorted[:, 0] = np.exp(distorted[:, 0])
    distorted[:, 5] = distorted[:, 5] ** 3
    distorted[:, 9] = np.arctan(distorted[:, 9]) * 10.0
    g0 = tdata.compute_gram(x_data, transform="rank", device="cpu")
    g1 = tdata.compute_gram(distorted, transform="rank", device="cpu")
    np.testing.assert_array_equal(_np(g0.s), _np(g1.s))


def test_rank_scores_match_reference(x_data):
    cols = np.concatenate([x_data[:, :6], np.round(x_data[:, 6:9], 1)],
                          axis=1)                       # some with ties
    panel = ttf.rank_transform_panel(torch.from_numpy(cols)).numpy()
    for j in range(cols.shape[1]):
        want = jtf.rank_transform_column(cols[:, j])
        got = ttf.rank_transform_column(torch.from_numpy(cols[:, j]))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=EXACT)
        np.testing.assert_allclose(panel[:, j], want, rtol=0, atol=EXACT)


def test_tied_ranks_are_exact():
    rng = np.random.default_rng(3)
    ties = rng.integers(0, 5, size=(200, 6)).astype(np.float64)
    ties[:, 5] = 2.0                                    # all tied
    for j in range(ties.shape[1]):
        got = ttf.average_ranks(torch.from_numpy(ties[:, j]))
        np.testing.assert_array_equal(got.numpy(),
                                      jtf.average_ranks(ties[:, j]))
    z = ttf.rank_transform_column(torch.from_numpy(ties[:, 5]))
    np.testing.assert_array_equal(z.numpy(), np.zeros(200))
    np.testing.assert_array_equal(
        ttf.average_ranks(torch.tensor([3.0, 1.0, 3.0, 2.0, 3.0, 1.0])),
        [5.0, 1.5, 5.0, 3.0, 5.0, 1.5])


def test_rank_requires_reiterable_source(x_data):
    gen = (x_data[lo:lo + 100] for lo in range(0, 900, 100))
    with pytest.raises(ValueError, match="re-iterable"):
        tdata.compute_gram(gen, transform="rank", device="cpu")


def test_rank_bounded_panels_match_wide_panels(x64, x_data):
    tight = tdata.compute_gram(tdata.as_source(x_data, chunk_rows=300),
                               transform="rank", budget_bytes=900 * 8,
                               device="cpu")
    wide = tdata.compute_gram(x_data, transform="rank", device="cpu")
    assert np.abs(_np(tight.s) - _np(wide.s)).max() < AGREE
    want = jdata.compute_gram(jdata.as_source(x_data, chunk_rows=300),
                              transform="rank", budget_bytes=900 * 8)
    _assert_gram_pair(tight, want)


def test_rank_refuses_an_unstable_source(x_data):
    sweeps = []

    def factory():
        sweeps.append(1)
        rows = 900 if len(sweeps) < 3 else 800
        return iter([x_data[:rows]])
    with pytest.raises(ValueError, match="not stable"):
        tdata.compute_gram(factory, transform="rank", device="cpu")


def test_rank_rejects_accumulator_and_unknown_names():
    with pytest.raises(ValueError, match="two-pass"):
        tdata.GramAccumulator(transform="rank", device="cpu")
    with pytest.raises(ValueError, match="unknown transform"):
        ttf.get_transform("zscore")
    assert ttf.available_transforms() == jtf.available_transforms()


def test_nonfinite_chunks_are_refused(x_data):
    bad = x_data.copy()
    bad[5, 5] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        tdata.compute_gram(bad, device="cpu")
    with pytest.raises(ValueError, match="non-finite"):
        tdata.compute_gram(bad, transform="rank", device="cpu")


# ---------------------------------------------------------------------------
# shard sources (the reference's file formats, in both directions)
# ---------------------------------------------------------------------------

def test_npy_shard_roundtrip(tmp_path, x_data):
    tdata.write_shards(x_data.astype(np.float32), tmp_path,
                       rows_per_shard=256)
    src = tdata.open_shards(tmp_path, chunk_rows=100)
    assert src.reiterable and src.p == 41 and src.n_rows == 900
    g = tdata.compute_gram(src, transform="center", device="cpu")
    ref = _dense_reference(x_data.astype(np.float32), "center")
    assert np.abs(_np(g.s) - ref).max() < AGREE
    assert g.source_dtype == "float32"


def test_raw_shard_roundtrip(tmp_path, x_data):
    paths = tdata.write_shards(torch.from_numpy(x_data), tmp_path,
                               rows_per_shard=333, raw=True)
    src = tdata.open_shards(paths, chunk_rows=128)
    assert src.n_rows == 900
    g = tdata.compute_gram(src, device="cpu")
    assert np.abs(_np(g.s) - x_data.T @ x_data / 900).max() < AGREE


@pytest.mark.parametrize("raw", [False, True], ids=["npy", "raw"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_shards_cross_packages(x64, tmp_path, x_data, writer, raw):
    """Shards written by one package open in the other, with the same
    file names and bytes."""
    x32 = x_data.astype(np.float32)
    dirs = {lib: tmp_path / lib for lib in ("reference", "port")}
    jpaths = jdata.write_shards(x32, dirs["reference"], rows_per_shard=250,
                                raw=raw)
    tpaths = tdata.write_shards(x32, dirs["port"], rows_per_shard=250,
                                raw=raw)
    assert [p.rsplit("/", 1)[1] for p in jpaths] \
        == [p.rsplit("/", 1)[1] for p in tpaths]
    for a, b in zip(jpaths, tpaths):
        assert open(a, "rb").read() == open(b, "rb").read()
    src = dirs[writer]
    got = tdata.compute_gram(tdata.open_shards(src, chunk_rows=128),
                             transform="standardize", device="cpu")
    want = jdata.compute_gram(jdata.open_shards(src, chunk_rows=128),
                              transform="standardize")
    _assert_gram_pair(got, want)


def test_mixed_shard_formats_rejected(tmp_path, x_data):
    paths = tdata.write_shards(x_data, tmp_path, rows_per_shard=500,
                               raw=True)
    np.save(tmp_path / "stray.npy", x_data[:10])
    with pytest.raises(ValueError, match="mixed shard formats"):
        tdata.open_shards(paths + [str(tmp_path / "stray.npy")])


def test_raw_shards_without_sidecar_rejected(tmp_path, x_data):
    paths = tdata.write_shards(x_data, tmp_path, rows_per_shard=500,
                               raw=True)
    (tmp_path / "shards_meta.json").unlink()
    with pytest.raises(ValueError, match="sidecar"):
        tdata.open_shards(paths)


def test_is_streaming_input_discriminates(x_data):
    cases = [(iter([x_data]), True), (lambda: iter([x_data]), True),
             (x_data, False), ([[1.0, 2.0], [3.0, 4.0]], False),
             ("some/dir", True)]
    for data, want in cases:
        assert t_is_streaming(data) is want
        assert j_is_streaming(data) is want
    assert t_is_streaming(tdata.as_source(x_data))
    assert not t_is_streaming(torch.zeros((3, 3)))
    chunks = list(tdata.as_source(torch.from_numpy(x_data),
                                  chunk_rows=400).chunks())
    assert [tuple(c.shape) for c in chunks] == [(400, 41), (400, 41),
                                               (100, 41)]
    assert all(isinstance(c, torch.Tensor) for c in chunks)


def test_one_shot_iterator_single_sweep_only(x_data):
    src = tdata.as_source(c for c in [x_data[:450], x_data[450:]])
    g = tdata.compute_gram(src, device="cpu")
    assert g.n == 900
    with pytest.raises(ValueError, match="consumed"):
        list(src.chunks())


# ---------------------------------------------------------------------------
# scenario suite
# ---------------------------------------------------------------------------

def test_scenario_registry_matches_reference():
    assert tdata.available_families() == jdata.available_families()
    assert set(FAMILIES) <= set(tdata.available_families())
    with pytest.raises(ValueError, match="unknown scenario family"):
        tdata.make_scenario("smallworld", p=16, device="cpu")


@pytest.mark.parametrize("family", FAMILIES)
def test_scenario_matches_reference(family):
    got = tdata.make_scenario(family, p=40, cond=12.0, seed=3, device="cpu")
    want = jdata.make_scenario(family, p=40, cond=12.0, seed=3)
    np.testing.assert_allclose(got.omega.numpy(), want.omega, rtol=0,
                               atol=EXACT)
    np.testing.assert_array_equal(got.omega.numpy() != 0, want.omega != 0)
    assert got.cond == pytest.approx(12.0, rel=1e-9)
    assert got.cond == pytest.approx(want.cond, rel=1e-12)
    ev = np.linalg.eigvalsh(got.omega.numpy())
    assert ev[0] > 0 and ev[-1] / ev[0] == pytest.approx(12.0, rel=1e-9)
    assert got.avg_degree == want.avg_degree
    # the seeded stream: the reference's chunks, re-iterable
    src = got.source(500, chunk_rows=128, seed=5)
    c1 = list(src.chunks())
    c2 = list(src.chunks())
    ref = list(want.source(500, chunk_rows=128, seed=5).chunks())
    assert [tuple(c.shape) for c in c1] == [r.shape for r in ref]
    for a, b, r in zip(c1, c2, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=EXACT)


def test_scenario_heavy_tails():
    got = tdata.make_scenario("banded", p=12, heavy_tail_df=4.0, seed=0,
                              device="cpu")
    x = got.sample(4000, seed=2).numpy()
    kurt = float(np.mean(x ** 4) / np.mean(x ** 2) ** 2)
    assert kurt > 4.0
    want = jdata.make_scenario("banded", p=12, heavy_tail_df=4.0, seed=0)
    np.testing.assert_allclose(x, want.sample(4000, seed=2), rtol=0,
                               atol=EXACT)


def test_scenario_stream_covariance_approaches_truth():
    sc = tdata.make_scenario("hub", p=20, cond=8.0, seed=1, device="cpu")
    g = tdata.compute_gram(sc.source(6000, chunk_rows=1000, seed=1),
                           device="cpu")
    emp = g.s.numpy()
    assert np.abs(emp - np.linalg.inv(sc.omega.numpy())).max() < 0.5


# ---------------------------------------------------------------------------
# the facade's streaming entry points against the JAX facade
# ---------------------------------------------------------------------------

def _pair(lam1=0.15):
    return (jest.ConcordEstimator(
                lam1=lam1, lam2=0.05, config=jest.SolverConfig(**KNOBS)),
            test_.ConcordEstimator(
                lam1=lam1, lam2=0.05,
                config=test_.SolverConfig(device="cpu", **KNOBS)))


def _assert_fits(jrep, trep):
    assert (trep.iters, trep.ls_total, trep.converged, trep.variant) \
        == (jrep.iters, jrep.ls_total, jrep.converged, jrep.variant)
    assert trep.variant == "cov"
    np.testing.assert_allclose(trep.omega.numpy(), np.asarray(jrep.omega),
                               rtol=0, atol=AGREE)


def test_fit_from_a_stream_matches_reference(x64, x_data):
    j, t = _pair()
    j.fit(x_data[lo:lo + 225] for lo in range(0, 900, 225))
    t.fit(x_data[lo:lo + 225] for lo in range(0, 900, 225))
    _assert_fits(j.report_, t.report_)


@pytest.mark.parametrize("transform", ["center", "standardize", "rank"])
def test_fit_with_transform_matches_reference(x64, x_data, transform):
    j, t = _pair(0.2)
    j.fit(x_data, transform=transform, chunk_rows=300)
    t.fit(x_data, transform=transform, chunk_rows=300)
    _assert_fits(j.report_, t.report_)


def test_fit_gram_matches_reference(x64, x_data):
    jg = jdata.compute_gram(x_data, transform="standardize", chunk_rows=200)
    j, t = _pair(0.2)
    j.fit_gram(jg)
    t.fit_gram(convert.gram_from_numpy(jg, device="cpu"))
    _assert_fits(j.report_, t.report_)
    # the port's own Gram of the same stream solves the same way
    t2 = _pair(0.2)[1].fit_gram(tdata.compute_gram(
        x_data, transform="standardize", chunk_rows=200, device="cpu"))
    _assert_fits(j.report_, t2.report_)


def test_fit_path_from_a_stream_matches_reference(x64, x_data):
    grid = [0.3, 0.2]
    jg = jdata.compute_gram(x_data, transform="center", chunk_rows=300)
    j, t = _pair()
    jpath = j.fit_path(s=jg.s, n_samples=jg.n, lam1_grid=grid)
    tpath = t.fit_path(tdata.as_source(x_data, chunk_rows=300), grid,
                       transform="center")
    assert tpath.best_bic().lam1 == jpath.best_bic().lam1
    for jr, tr in zip(jpath, tpath):
        _assert_fits(jr, tr)
        assert tr.bic == pytest.approx(jr.bic, rel=1e-9)
    fpath = test_.fit_path(x_data, grid, transform="center", chunk_rows=300,
                           lam2=0.05, device="cpu", **KNOBS)
    for jr, fr in zip(jpath, fpath):
        _assert_fits(jr, fr)


def test_functional_fit_passes_transform_through(x64, x_data):
    want = jest.fit(x_data, lam1=0.2, lam2=0.05, transform="rank",
                    chunk_rows=250, **KNOBS)
    got = test_.fit(x_data, lam1=0.2, lam2=0.05, transform="rank",
                    chunk_rows=250, device="cpu", **KNOBS)
    _assert_fits(want, got)


def test_fit_gram_duck_typing_and_validation(x_data):
    est = _pair(0.2)[1]
    with pytest.raises(TypeError, match="GramResult-like"):
        est.fit_gram(np.eye(4))
    g = tdata.compute_gram(x_data, transform="standardize", device="cpu")
    with pytest.raises(ValueError, match="NaN/Inf"):
        est.fit_gram(g._replace(s=torch.full_like(g.s, float("nan"))))
    # the Gram tensor is solved where it is, with no copy
    est.fit_gram(g)
    assert est.report_.device == "cpu"


def test_gram_from_numpy_carries_every_field(x_data):
    jg = jdata.compute_gram(x_data.astype(np.float32), chunk_rows=200)
    tg = convert.gram_from_numpy(jg, device="cpu")
    assert isinstance(tg, tdata.GramResult)
    assert tg._fields == jg._fields
    assert tg.to_meta() == pytest.approx(jg.to_meta())
    np.testing.assert_array_equal(tg.s.numpy(), jg.s)


# ---------------------------------------------------------------------------
# chunk-size guidance, later slices, devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [1, 64, 1024, 16384, 30000])
def test_gram_chunk_rows_matches_reference(p):
    """The same constants give the same rows; the packages' default
    machines differ (a 16 GB TPU against the 80 GB H100)."""
    for hbm in (16e9, 80e9):
        kw = dict(hbm_bytes=hbm)
        try:
            want = jcost.gram_chunk_rows(p, machine=jcost.Machine(**kw))
        except ValueError:
            with pytest.raises(ValueError, match="accumulator alone"):
                tcost.gram_chunk_rows(p, machine=tcost.Machine(**kw))
            continue
        assert tcost.gram_chunk_rows(p, machine=tcost.Machine(**kw)) == want
    assert tcost.gram_chunk_rows(p, budget_bytes=p * p * 8 + 1e6) \
        == jcost.gram_chunk_rows(p, budget_bytes=p * p * 8 + 1e6)


def test_gram_chunk_rows_default_machine_and_refusals():
    assert tcost.gram_chunk_rows(16384) == 29954
    assert 256 <= tcost.gram_chunk_rows(1024) <= 1 << 20
    with pytest.raises(ValueError, match="accumulator alone"):
        tcost.gram_chunk_rows(10 ** 6)
    with pytest.raises(ValueError):
        tcost.gram_chunk_rows(0)


def test_distributed_gram_raises_naming_its_slice(x_data):
    with pytest.raises(NotImplementedError, match="A8"):
        tdata.distributed_gram([x_data[:450], x_data[450:]])


def test_data_entry_points_need_a_card_unless_cpu(monkeypatch, x_data):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tdata.compute_gram(x_data),
                 lambda: tdata.compute_gram(x_data, transform="rank"),
                 lambda: tdata.GramAccumulator(),
                 lambda: tdata.make_scenario("banded", p=8),
                 lambda: convert.gram_from_numpy(
                     jdata.compute_gram(x_data[:, :4]))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tdata.compute_gram(x_data, device="cpu").s.device.type == "cpu"
