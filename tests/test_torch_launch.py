"""The port's solver CLIs (``repro_torch.launch.gram`` and
``repro_torch.launch.solve``) against the JAX package's, on the CPU in
float64: ``prep`` artifacts cross between the packages in both
directions (S within 1e-10, the same metadata keys, the same Omega
within 1e-10 at ``--backend reference``), the synthetic solve path, and
the distributed backend at world size 1 and the refusals (an
infeasible grid, no card)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import gram as jgram
from repro.launch import solve as jsolve
from repro_torch import estimator as test_
from repro_torch.core import graphs as tgraphs
from repro_torch.launch import gram as tgram
from repro_torch.launch import solve as tsolve

from _torch_parity import x64  # noqa: F401

AGREE = 1e-10
REPO = Path(__file__).resolve().parents[1]

#: metadata keys whose values depend on the run's clock
RUN_KEYS = {"wall_time_s", "rows_per_s"}

SOLVE = ["--lam1", "0.2", "--backend", "reference", "--max-iters", "150",
         "--sparse-matmul", "on", "--sparse-block", "8",
         "--sparse-threshold", "0.5"]


def _prep(lib, out, *args):
    argv = ["prep", *args, "--out", str(out)]
    if lib == "port":
        return tgram.main(argv, device="cpu")
    return jgram.main(argv)


def _solve(lib, *args):
    if lib == "port":
        return tsolve.main(list(args), device="cpu")
    return jsolve.main(list(args))


def _meta(out):
    with open(os.path.join(out, "gram_meta.json")) as f:
        return json.load(f)


def _assert_same_artifact(a, b):
    ma, mb = _meta(a), _meta(b)
    assert ma.keys() == mb.keys()
    for k in ma.keys() - RUN_KEYS - {"mean", "var", "mean_absmax",
                                     "diag_mean", "source"}:
        assert ma[k] == mb[k], k
    # the source's float values (a scenario's achieved condition number)
    # come from two LAPACK builds' eigvalsh, which may part in the last
    # ulp; the rest of the source exactly
    sa, sb = ma["source"], mb["source"]
    if isinstance(sa, dict) and isinstance(sb, dict):
        assert sa.keys() == sb.keys(), "source"
        for k in sa:
            if isinstance(sa[k], float) or isinstance(sb[k], float):
                np.testing.assert_allclose(sa[k], sb[k], rtol=1e-12, atol=0,
                                           err_msg=f"source/{k}")
            else:
                assert sa[k] == sb[k], f"source/{k}"
    else:
        assert sa == sb, "source"
    for k in ("mean", "var", "mean_absmax", "diag_mean"):
        np.testing.assert_allclose(ma[k], mb[k], rtol=0, atol=1e-12)
    sa, sb = (np.load(os.path.join(d, "S.npy")) for d in (a, b))
    assert sa.dtype == sb.dtype == np.float64
    np.testing.assert_allclose(sa, sb, rtol=0, atol=AGREE)


def _assert_same_fit(jrep, trep):
    assert (trep.iters, trep.ls_total, trep.converged, trep.variant) \
        == (jrep.iters, jrep.ls_total, jrep.converged, jrep.variant)
    np.testing.assert_allclose(trep.omega.numpy(), np.asarray(jrep.omega),
                               rtol=0, atol=AGREE)


SCENARIO = ["--scenario", "hub", "--p", "32", "--n", "3000",
            "--chunk-rows", "512"]


@pytest.mark.parametrize("transform", ["standardize", "rank"])
@pytest.mark.parametrize("prepped_by", ["reference", "port"])
def test_artifact_crosses_packages(x64, tmp_path, prepped_by, transform):
    """An artifact prepped by either package is solved by both, to the
    same Omega; both packages prep the same artifact."""
    outs = {lib: tmp_path / lib for lib in ("reference", "port")}
    for lib, out in outs.items():
        _prep(lib, out, *SCENARIO, "--transform", transform)
    _assert_same_artifact(outs["reference"], outs["port"])
    art = str(outs[prepped_by])
    jrep = _solve("reference", "--from-gram", art, *SOLVE)
    trep = _solve("port", "--from-gram", art, *SOLVE)
    assert trep.variant == "cov" and tuple(trep.omega.shape) == (32, 32)
    _assert_same_fit(jrep, trep)


@pytest.mark.parametrize("raw", [False, True], ids=["npy", "raw"])
def test_prep_from_shards_matches_reference(x64, tmp_path, raw):
    from repro_torch.data import write_shards
    x = np.random.default_rng(4).standard_normal((1500, 24))
    write_shards(x.astype(np.float32), tmp_path / "shards",
                 rows_per_shard=400, raw=raw)
    for lib in ("reference", "port"):
        _prep(lib, tmp_path / lib, "--shards", str(tmp_path / "shards"),
              "--chunk-rows", "300", "--transform", "center")
    _assert_same_artifact(tmp_path / "reference", tmp_path / "port")
    meta = _meta(tmp_path / "port")
    assert meta["source_dtype"] == "float32" and meta["n_chunks"] == 7
    assert meta["peak_bytes_streamed"] < meta["peak_bytes_dense"]


def test_solve_path_from_gram_matches_reference(x64, tmp_path):
    _prep("port", tmp_path, *SCENARIO, "--transform", "standardize")
    grid = ["--path", "0.3,0.2,0.15"]
    jrep = _solve("reference", "--from-gram", str(tmp_path), *SOLVE, *grid)
    trep = _solve("port", "--from-gram", str(tmp_path), *SOLVE, *grid)
    assert trep.lam1 == jrep.lam1
    assert trep.bic == pytest.approx(jrep.bic, rel=1e-9)
    _assert_same_fit(jrep, trep)


def test_load_gram_round_trip_and_sidecar(tmp_path):
    _prep("port", tmp_path / "art", *SCENARIO)
    g = tgram.load_gram(str(tmp_path / "art" / "S.npy"), device="cpu")
    assert (g.n, g.p, g.transform, g.n_chunks) == (3000, 32, "standardize",
                                                   6)
    assert g.s.dtype == torch.float64 and g.mean.shape == (32,)
    os.remove(tmp_path / "art" / "gram_meta.json")
    with pytest.raises(FileNotFoundError, match="sidecar"):
        tgram.load_gram(str(tmp_path / "art"), device="cpu")


def test_prep_needs_exactly_one_source(tmp_path):
    with pytest.raises(SystemExit):
        _prep("port", tmp_path, "--scenario", "hub", "--shards", "x")
    with pytest.raises(SystemExit):
        _prep("port", tmp_path)


def test_families_subcommand_matches_reference(capsys):
    assert tgram.main(["families"]) == jgram.main(["families"])


def test_synthetic_solve_runs_the_port_facade(capsys):
    """The synthetic path: ``graphs.make_problem`` and the cost-model
    line, then the same solve the facade gives on the same problem."""
    argv = ["--p", "40", "--n", "120", "--lam1", "0.3", "--backend",
            "reference", "--variant", "cov", "--seed", "2"]
    rep = _solve("port", *argv)
    out = capsys.readouterr().out
    assert "[costmodel] P=1:" in out and "PPV" in out
    prob = tgraphs.make_problem("chain", 40, 120, seed=2)
    cfg = test_.SolverConfig(backend="reference", variant="cov", tol=1e-5,
                             max_iters=300, device="cpu")
    want = test_.ConcordEstimator(lam1=0.3, lam2=0.05,
                                  config=cfg).fit(prob.x).report_
    assert (rep.iters, rep.ls_total) == (want.iters, want.ls_total)
    np.testing.assert_array_equal(rep.omega.numpy(), want.omega.numpy())
    best = _solve("port", *argv, "--path", "0.4,0.3", "--path-mode",
                  "batched")
    assert best.lam1 in (0.4, 0.3)


@pytest.mark.parametrize("argv", [["--backend", "distributed"],
                                  ["--cx", "2"], ["--comega", "2"]])
def test_distributed_choices_raise_naming_their_slice(argv, x64,
                                                     tmp_path):
    """At world size 1 ``--backend distributed`` solves on the
    one-process grid, as the reference does on one device (from an f64
    Gram artifact: f32 counts are never compared across packages); a
    replication factor above 1 is the reference's infeasible-grid error,
    word for word."""
    art = tmp_path / "art"
    _prep("port", art, *SCENARIO)
    argv = [*argv, "--from-gram", str(art), "--lam1", "0.2",
            "--max-iters", "150"]
    try:
        want = _solve("reference", *argv)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            _solve("port", *argv)
        assert str(got.value) == str(exc)
        return
    rep = _solve("port", *argv)
    _assert_same_fit(want, rep)
    assert (rep.backend, rep.n_devices, rep.c_x, rep.c_omega) == \
        (want.backend, want.n_devices, want.c_x, want.c_omega)


def test_cli_entry_points_need_a_card_unless_cpu(monkeypatch, tmp_path):
    _prep("port", tmp_path / "art", *SCENARIO)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tsolve.main(["--from-gram", str(tmp_path / "art")]),
                 lambda: tsolve.main(["--p", "20", "--n", "40"]),
                 lambda: tgram.main(["prep", *SCENARIO, "--out",
                                     str(tmp_path / "b")]),
                 lambda: tgram.load_gram(str(tmp_path / "art"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_cli_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.gram", "families"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == jgram.available_families()
