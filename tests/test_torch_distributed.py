"""The port's distributed CONCORD solve (``repro_torch.core.distributed``)
against ``repro.core.distributed`` on the CPU, in float64.

The port's ranks are spawned processes joined over gloo
(``test_torch_ranks.RankPool``); the reference runs in one subprocess with 8
virtual XLA devices (as ``tests/conftest.py::run_with_devices`` does) and
hands its results back as ``.npz``.  Both get the same numpy inputs.

  * the solves of the reference test (``tests/test_comm_distributed.py``:
    the chain problem at p = 50, n = 120, lam1 0.15, lam2 0.05, tol 1e-6)
    on its grids, dense and block-sparse (block 2), and one weighted-l1
    case: equal iterations, trials, ``converged`` and ``stalled``, Omega
    within 1e-10 and ``g_final`` within 1e-10 relative — and the same
    against the port's own single-device solve;
  * at P = 4: the facade's ``distributed`` and ``auto`` backends,
    ``data.distributed_gram`` and ``launch.solve --backend distributed``.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.estimator import backends as jbackends
from repro.estimator import config as jconfig
from repro_torch import estimator as test_
from repro_torch.core import costmodel as tcost
from repro_torch.core import graphs as tgraphs
from repro_torch.core import matops as tmatops
from repro_torch.core import prox as tprox
from repro_torch.core.penalty import PenaltySpec
from repro_torch.data import compute_gram
from repro_torch.estimator import backends as tbackends
from repro_torch.launch import gram as tgram

import test_torch_ranks as td
from test_torch_ranks import RankPool

from _torch_parity import reference_env

AGREE = 1e-10
LAM1, LAM2, TOL, MAX_ITERS = 0.15, 0.05, 1e-6, 200

#: (variant, c_x, c_omega, case): the reference test's grids at P = 8
CASES = [
    ("cov", 1, 1, "l1"), ("cov", 1, 1, "sparse"),
    ("cov", 2, 2, "l1"), ("cov", 2, 2, "sparse"),
    ("obs", 1, 1, "l1"), ("obs", 1, 1, "sparse"),
    ("obs", 4, 2, "l1"), ("obs", 4, 2, "sparse"),
    ("obs", 1, 8, "l1"), ("obs", 1, 8, "sparse"),
    ("cov", 2, 2, "weighted"),
]


def _cid(case):
    return "{}-cx{}-co{}-{}".format(*case)


def _problem():
    prob = tgraphs.make_problem("chain", p=50, n=120, seed=0)
    rng = np.random.default_rng(3)
    w = np.abs(rng.standard_normal((50, 50))) + 0.5
    return (np.asarray(prob.s, np.float64), np.asarray(prob.x, np.float64),
            (w + w.T) / 2)


def _case_kw(case):
    """(sparse block or None, weights or None, use_pallas) of a case."""
    kind = case[3]
    return (None if kind == "l1" else 2,
            _problem()[2] if kind == "weighted" else None,
            kind != "l1")


_REFERENCE = """
import sys, warnings
import numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
from repro.comm.grid import Grid1p5D
from repro.core import matops
from repro.core.distributed import fit_cov, fit_obs
from repro.core.penalty import PenaltySpec
warnings.simplefilter("ignore")
inp = np.load(sys.argv[1])
cases = [line.split() for line in sys.argv[3].split(";")]
out = {}
for cid, variant, cx, co, block, weighted, pallas in cases:
    pol = None if block == "-" else matops.MatmulPolicy(
        mode="on", block_size=int(block), threshold=0.25)
    kw = dict(grid=Grid1p5D(8, int(cx), int(co)), tol=%(tol)r,
              max_iters=%(max_iters)d, sparse_matmul=pol,
              use_pallas=pallas == "1")
    if weighted == "1":
        kw["penalty"] = PenaltySpec.weighted_l1(%(lam1)r,
                                                jnp.asarray(inp["w"]),
                                                %(lam2)r)
    else:
        kw.update(lam1=%(lam1)r, lam2=%(lam2)r)
    fit = fit_cov if variant == "cov" else fit_obs
    r = fit(jnp.asarray(inp["s" if variant == "cov" else "x"]), **kw)
    for k in ("omega", "iters", "ls_total", "converged", "stalled",
              "g_final", "block_density"):
        out[cid + "/" + k] = np.asarray(getattr(r, k))
np.savez(sys.argv[2], **out)
print("OK")
""" % dict(tol=TOL, max_iters=MAX_ITERS, lam1=LAM1, lam2=LAM2)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's reference solve, in one 8-device subprocess."""
    d = tmp_path_factory.mktemp("dist_ref")
    s, x, w = _problem()
    np.savez(d / "in.npz", s=s, x=x, w=w)
    spec = ";".join(
        " ".join([_cid(c), c[0], str(c[1]), str(c[2]),
                  "-" if _case_kw(c)[0] is None else str(_case_kw(c)[0]),
                  "1" if c[3] == "weighted" else "0",
                  "1" if _case_kw(c)[2] else "0"]) for c in CASES)
    env = reference_env(8)
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(d / "in.npz"),
         str(d / "out.npz"), spec], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = np.load(d / "out.npz")
    return {k: out[k] for k in out.files}


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(world):
        if world not in made or not made[world].alive:
            made[world] = RankPool(world)
        return made[world]
    yield get
    for pool in made.values():
        pool.close()


def _assert_same(got, want, what):
    assert (got["iters"], got["ls_total"], got["converged"],
            got["stalled"]) == (want["iters"], want["ls_total"],
                                want["converged"], want["stalled"]), what
    np.testing.assert_allclose(got["omega"], want["omega"], rtol=0,
                               atol=AGREE, err_msg=what)
    assert abs(got["g_final"] - want["g_final"]) <= \
        AGREE * max(1.0, abs(want["g_final"])), what


@pytest.mark.filterwarnings("ignore:sparse_matmul block_size")
@pytest.mark.parametrize("case", CASES, ids=_cid)
def test_solve_matches_reference_and_single_device(pools, reference, case):
    variant, cx, co, _ = case
    s, x, _ = _problem()
    data = s if variant == "cov" else x
    block, weights, pallas = _case_kw(case)
    kw = dict(tol=TOL, max_iters=MAX_ITERS, use_pallas=pallas)
    res = pools(8).run(td.solve, 8, cx, co, variant, data, LAM1, LAM2,
                       block, weights, kw)
    got = res[0]
    for r in res[1:]:               # every rank holds the same estimate
        np.testing.assert_array_equal(r["omega"], got["omega"])
        assert r["iters"] == got["iters"]
    cid = _cid(case)
    want = {k: reference[f"{cid}/{k}"].item() if k != "omega"
            else reference[f"{cid}/omega"]
            for k in ("omega", "iters", "ls_total", "converged", "stalled",
                      "g_final", "block_density")}
    _assert_same(got, want, f"{cid} vs repro.core.distributed")
    assert got["block_density"] == pytest.approx(want["block_density"],
                                                 abs=1e-7)
    # the port's own single-device solve of the same problem
    pen = (PenaltySpec.weighted_l1(LAM1, weights, LAM2)
           if weights is not None else PenaltySpec.l1(LAM1, LAM2))
    pol = None if block is None else tmatops.MatmulPolicy("on", block, 0.25)
    one = tprox.solve_reference(
        torch.as_tensor(data), penalty=pen, variant=variant, tol=TOL,
        max_iters=MAX_ITERS, sparse_matmul=pol, use_kernels=pallas)
    _assert_same(got, dict(omega=one.omega.numpy(), iters=one.iters,
                           ls_total=one.ls_total, converged=one.converged,
                           stalled=one.stalled, g_final=one.g_final),
                 f"{cid} vs the single-device solve")


def _facade_problem():
    prob = tgraphs.make_problem("chain", p=24, n=300, seed=1)
    return np.asarray(prob.x, np.float64)


@pytest.mark.parametrize("backend", ["distributed", "auto"])
def test_facade_picks_the_reference_grid_at_world_size_4(
        pools, backend, monkeypatch):
    """Both backends resolve (variant, c_x, c_omega) as the reference's
    ``_resolve_variant`` does on the same shape and machine constants,
    and solve on that grid."""
    x = _facade_problem()
    res = pools(4).run(td.facade, x, 0.2, backend, {})
    got = res[0]
    assert all(r["c_x"] == got["c_x"] for r in res)
    assert got["backend"] == "distributed" and got["n_devices"] == 4
    # the reference's choice with the port's H100 constants
    monkeypatch.setattr(jbackends, "Machine",
                        lambda: _ref_machine(tcost.H100))
    jprob = jbackends.Problem.from_data(x=x)
    jchoice = jbackends._resolve_variant(
        jprob, 0.2, jconfig.SolverConfig(), 4)
    tchoice = tbackends._resolve_variant(
        test_.Problem.from_data(x=x, device="cpu"), 0.2,
        test_.SolverConfig(), 4)
    assert tchoice == jchoice == (got["variant"], got["c_x"],
                                  got["c_omega"])
    # the same solve on one process
    cfg = test_.SolverConfig(backend="reference", variant=got["variant"],
                             device="cpu")
    one = test_.ConcordEstimator(lam1=0.2, lam2=0.05, config=cfg).fit(
        x).report_
    assert (got["iters"], got["ls_total"]) == (one.iters, one.ls_total)
    np.testing.assert_allclose(got["omega"], one.omega.numpy(), rtol=0,
                               atol=AGREE)


def _ref_machine(m):
    from repro.core.costmodel import Machine
    return Machine(name=m.name, peak_flops=m.peak_flops, hbm_bw=m.hbm_bw,
                   link_bw=m.link_bw, msg_overhead=m.msg_overhead,
                   hbm_bytes=m.hbm_bytes, word_bytes=m.word_bytes)


@pytest.mark.parametrize("transform", ["none", "standardize"])
def test_distributed_gram_over_four_ranks(pools, transform):
    x = np.random.default_rng(4).standard_normal((203, 9)) * 3.0 + 1.0
    res = pools(4).run(td.gram, x, transform)
    want = compute_gram(x, transform=transform, device="cpu")
    for g in res:
        assert (g["n"], g["p"]) == (203, 9)
        assert g["n_chunks"] == sum(-(-len(r) // 25)
                                    for r in np.array_split(x, 4))
        np.testing.assert_allclose(g["s"], want.s.numpy(), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(g["mean"], want.mean.numpy(), rtol=0,
                                   atol=1e-12)
        np.testing.assert_array_equal(g["s"], res[0]["s"])


def test_solve_cli_distributed_in_a_four_rank_group(pools, tmp_path):
    art = tmp_path / "art"
    tgram.main(["prep", "--scenario", "hub", "--p", "32", "--n", "3000",
                "--chunk-rows", "512", "--out", str(art)], device="cpu")
    argv = ["--from-gram", str(art), "--lam1", "0.2", "--max-iters", "150",
            "--sparse-matmul", "on", "--sparse-block", "4",
            "--sparse-threshold", "0.5"]
    res = pools(4).run(td.cli, argv + ["--backend", "distributed", "--cx",
                                       "2", "--comega", "2"])
    from repro_torch.launch import solve
    one = solve.main(argv + ["--backend", "reference"], device="cpu")
    for r in res:
        assert (r["backend"], r["n_devices"], r["c_x"], r["c_omega"]) == \
            ("distributed", 4, 2, 2)
        assert (r["iters"], r["ls_total"]) == (one.iters, one.ls_total)
        np.testing.assert_allclose(r["omega"], one.omega.numpy(), rtol=0,
                                   atol=AGREE)
