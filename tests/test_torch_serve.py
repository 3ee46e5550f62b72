"""The port's serving launcher (``repro_torch.launch.serve``): the
``--workload concord`` micro-batching drain (bucketing, tail padding,
dropped padding, the batched-vs-sequential agreement), its parity with
``repro.launch.serve`` on the same arguments, the obs latency split, and
the CLI's ``--workload lm`` on every family (its ``serve_batch``
parity with the reference is in ``test_torch_lm_serve.py``; here the
CLI's tokens against the reference CLI's)."""
import argparse
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.estimator as est_mod
from repro.launch import serve as jserve
from repro_torch.launch.serve import ConcordServeStats, main, serve_concord

import _torch_parity  # noqa: F401  (one torch thread per test worker)


def _args(**overrides) -> argparse.Namespace:
    base = dict(requests=5, batch=2, p=16, n=48, lam2=0.05,
                tol=1e-4, max_iters=60, seed=0)
    base.update(overrides)
    return argparse.Namespace(**base)


@pytest.fixture(scope="module")
def drained():
    """One real drain shared by the cheap asserts below (5 requests in
    micro-batches of 2: two full groups + one padded tail group)."""
    return serve_concord(_args(), device="cpu")


def test_serve_concord_returns_all_requests_in_order(drained):
    assert isinstance(drained, ConcordServeStats)
    assert len(drained.reports) == 5
    # per-request penalties survive bucketing + padding in input order
    for rep, lam1 in zip(drained.reports, drained.lam1s):
        assert rep.lam1 == pytest.approx(float(lam1))
        assert rep.device == "cpu"


def test_serve_concord_pads_tail_group_for_program_reuse(drained):
    """5 requests at batch=2 -> 3 batched calls, and the tail group is
    PADDED to the same (B, n, p) shape as the full groups."""
    assert drained.n_groups == 3
    assert len(set(drained.group_shapes)) == 1
    assert drained.group_shapes[0] == (2, 48, 16)


def test_serve_concord_padding_results_are_dropped(drained):
    """The padding replica of the last request must not leak into the
    drained queue: exactly `requests` reports, and the final report solves
    the final request's lam1 (not a duplicate row)."""
    assert len(drained.reports) == 5
    assert drained.reports[-1].lam1 == pytest.approx(float(drained.lam1s[-1]))
    assert sorted(drained.order.tolist()) == list(range(5))


def test_serve_concord_batched_agrees_with_sequential(drained):
    """The drain cross-checks every batched estimate against a
    sequential solve of the same request, at the reference's gate."""
    assert np.isfinite(drained.max_gap)
    assert drained.max_gap < 5e-3


def test_serve_concord_exact_multiple_needs_no_padding(monkeypatch):
    """4 requests at batch=2: two groups, no padding anywhere."""
    calls = []
    real = est_mod.fit_batch

    def spy(x=None, **kw):
        calls.append(tuple(x.shape))
        return real(x=x, **kw)

    monkeypatch.setattr(est_mod, "fit_batch", spy)
    stats = serve_concord(_args(requests=4), device="cpu")
    assert calls == [(2, 48, 16), (2, 48, 16)]
    assert stats.n_groups == 2 and len(stats.reports) == 4


def test_serve_concord_single_request_pads_to_full_batch():
    stats = serve_concord(_args(requests=1, batch=3), device="cpu")
    assert stats.n_groups == 1
    assert stats.group_shapes == [(3, 48, 16)]
    assert len(stats.reports) == 1


@pytest.mark.parametrize("overrides", [{}, dict(requests=7, batch=3,
                                                p=12, seed=3)],
                         ids=["5x2", "7x3"])
def test_serve_concord_matches_the_reference(overrides):
    """Same arguments, same drain as ``repro.launch.serve``: penalties,
    order, groups and shapes equal; each estimate within the reference's
    own 5e-3 gate (the requests are f32 on both sides, so the iteration
    counts are not compared across packages)."""
    from repro.launch.serve import serve_concord as jserve
    args = _args(**overrides)
    want = jserve(args)
    got = serve_concord(args, device="cpu")
    np.testing.assert_array_equal(got.lam1s, want.lam1s)
    np.testing.assert_array_equal(got.order, want.order)
    assert got.n_groups == want.n_groups
    assert got.group_shapes == want.group_shapes
    for g, w in zip(got.reports, want.reports):
        assert g.lam1 == w.lam1
        assert g.omega.dtype == torch.float32
        np.testing.assert_allclose(g.omega.numpy(), np.asarray(w.omega),
                                   rtol=0, atol=5e-3)


def test_serve_obs_latency_split():
    from repro_torch.obs import metrics, trace
    metrics.get_registry().clear()
    trace.get_tracer().clear()
    stats = serve_concord(argparse.Namespace(
        requests=4, batch=2, p=16, n=40, lam2=0.05, tol=1e-4,
        max_iters=40, seed=0, obs="summary"), device="cpu")
    try:
        for arr in (stats.queue_wait_s, stats.solve_wall_s, stats.latency_s):
            assert arr is not None and arr.shape == (4,)
            assert np.all(arr >= 0)
        np.testing.assert_allclose(stats.latency_s,
                                   stats.queue_wait_s + stats.solve_wall_s)
        # groups launch one after another, so at least one request waited
        # behind another group's solve
        assert stats.queue_wait_s.max() > 0
        snap = metrics.get_registry().snapshot()
        assert snap["repro_serve_latency_seconds"]["count"] == 4
        assert snap["repro_serve_queue_wait_seconds"]["count"] == 4
        assert snap["repro_serve_solve_wall_seconds"]["count"] == 4
        spans = trace.get_tracer().snapshot()
        assert [s.name for s in spans].count("serve.group") == 2
        assert [s.name for s in spans].count("serve.request") == 4
        assert trace.get_tracer().mode == "off"
    finally:
        metrics.get_registry().clear()
        trace.get_tracer().clear()


def test_main_runs_concord_and_refuses_lm(monkeypatch):
    stats = main(["--workload", "concord", "--requests", "3", "--batch",
                  "2", "--p", "12", "--n", "40", "--max-iters", "40"],
                 device="cpu")
    assert stats.n_groups == 2 and len(stats.reports) == 3
    toks = main(["--arch", "h2o-danube-1.8b", "--smoke"], device="cpu")
    assert toks.shape == (4, 32) and toks.dtype == torch.int32
    assert bool(((toks >= 0) & (toks < 256)).all())
    with pytest.raises(SystemExit):                 # --arch is required
        main([], device="cpu")
    # the SSM family serves too: the reference CLI's tokens
    argv = ["--arch", "mamba2-130m", "--smoke"]
    got, want = _lm_mains_on_reference_weights(monkeypatch, argv)
    assert got.shape == (4, 32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-small"])
def test_main_lm_serves_hybrid_and_enc_dec(monkeypatch, arch):
    """The CLI on the hybrid and on Whisper (its stub frames: zeros of
    (B, enc_len, d) in the compute dtype, as the reference builds them):
    the reference CLI's tokens."""
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "12",
            "--gen", "8"]
    got, want = _lm_mains_on_reference_weights(monkeypatch, argv)
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


def _lm_mains_on_reference_weights(monkeypatch, argv):
    """(port tokens, reference tokens) of ``main(argv)`` in both packages,
    the port's on the CPU with ``init_params`` drawing the reference's
    weights (at the CLI's seed and max_len).  Both run the smoke config
    at float32: at its bfloat16 the greedy tokens of two libraries part
    at the first near-tie of random weights (mamba2's after 3 of 8
    tokens, from logits that agree to bf16 ulps)."""
    import jax
    from repro import configs as jconfigs
    from repro.models import transformer as jT
    from repro_torch import configs as tconfigs
    from repro_torch import convert
    from repro_torch.models import transformer as tT

    jget, tget = jconfigs.get_smoke, tconfigs.get_smoke
    monkeypatch.setattr(jconfigs, "get_smoke",
                        lambda name: jget(name).with_(dtype="float32"))
    monkeypatch.setattr(tconfigs, "get_smoke",
                        lambda name: tget(name).with_(dtype="float32"))

    def reference_init(cfg, seed=0, max_len=0, device=None):
        jcfg = jconfigs.get_smoke(argv[argv.index("--arch") + 1])
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
        params = jT.init_params(jcfg, jax.random.PRNGKey(seed), max_len)
        return convert.lm_params_from_numpy(
            cfg, jax.tree.map(np.asarray, params), device=device)

    monkeypatch.setattr(tT, "init_params", reference_init)
    toks = main(argv, device="cpu")
    assert toks.dtype == torch.int32
    return toks.numpy(), np.asarray(jserve.main(argv))

