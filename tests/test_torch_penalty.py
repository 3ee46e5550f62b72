"""Parity of the port's objective and penalties with the JAX reference:
every kind's prox bit-equal in float64, values at 1e-12, the same
parse/validation errors."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import objective as jobj
from repro.core import penalty as jpen
from repro_torch.core import objective as tobj
from repro_torch.core import penalty as tpen

from _torch_parity import x64  # noqa: F401

P = 24


def _z(seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((P, P))
    z[np.abs(z) < 0.05] = 0.0          # exact zeros exercise sign(0)
    return z


def _weights(seed=1):
    rng = np.random.default_rng(seed)
    w = np.abs(rng.standard_normal((P, P))) + 0.1
    w = 0.5 * (w + w.T)
    w[2, 7] = w[7, 2] = np.inf          # structural zero
    w[3, 4] = w[4, 3] = 0.0             # unpenalized edge
    w[np.diag_indices(P)] = 0.0
    return w


def _specs(kind, lam1=0.4, lam2=0.05):
    if kind == "weighted_l1":
        w = _weights()
        return (jpen.PenaltySpec.weighted_l1(lam1, jnp.asarray(w), lam2),
                tpen.PenaltySpec.weighted_l1(lam1, w, lam2))
    if kind in ("scad", "mcp"):
        return (getattr(jpen.PenaltySpec, kind)(lam1, lam2=lam2),
                getattr(tpen.PenaltySpec, kind)(lam1, lam2=lam2))
    if kind == "elastic_net":
        return (jpen.PenaltySpec.elastic_net(lam1, lam2),
                tpen.PenaltySpec.elastic_net(lam1, lam2))
    return jpen.PenaltySpec.l1(lam1, lam2), tpen.PenaltySpec.l1(lam1, lam2)


KINDS = ["l1", "elastic_net", "weighted_l1", "scad", "mcp"]


@pytest.mark.parametrize("tau", [1.0, 0.37, 0.0625])
@pytest.mark.parametrize("kind", KINDS)
def test_prox_bit_equal(x64, kind, tau):
    js, ts = _specs(kind)
    z = _z()
    want = np.asarray(js.prox(jnp.asarray(z), tau))
    got = ts.prox(torch.as_tensor(z), tau).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_prox_explicit_diag_mask_bit_equal(x64, kind):
    js, ts = _specs(kind)
    z = _z(3)
    m = np.zeros((P, P))
    m[np.arange(0, P, 2), np.arange(0, P, 2)] = 1.0   # a partial panel mask
    want = np.asarray(js.prox(jnp.asarray(z), 0.5, jnp.asarray(m)))
    got = ts.prox(torch.as_tensor(z), 0.5, torch.as_tensor(m)).numpy()
    np.testing.assert_array_equal(got, want)


def test_weighted_inf_and_zero_weights_at_alpha_zero(x64):
    """alpha = tau * lam1 = 0: inf weights still force exact zeros (the
    inf * 0 = nan guard), zero weights pass z through."""
    w = _weights()
    z = _z(4)
    js = jpen.PenaltySpec.weighted_l1(0.0, jnp.asarray(w))
    ts = tpen.PenaltySpec.weighted_l1(0.0, w)
    got = ts.prox(torch.as_tensor(z), 1.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(js.prox(jnp.asarray(z),
                                                          1.0)))
    assert got[2, 7] == 0.0 and got[7, 2] == 0.0
    assert got[3, 4] == z[3, 4]
    assert not np.isnan(got).any()


@pytest.mark.parametrize("kind", KINDS)
def test_value_matches(x64, kind):
    js, ts = _specs(kind)
    om = _z(5)
    om[2, 7] = om[7, 2] = 0.0          # inf weight meets a zero entry
    want = float(js.value(jnp.asarray(om)))
    got = float(ts.value(torch.as_tensor(om)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tpen.penalty_value(ts, torch.as_tensor(om)),
                               jpen.penalty_value_np(js, om),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("text", ["l1", "elastic_net", "scad", "scad:3.2",
                                  "mcp", "mcp:2.5", "weighted_l1"])
def test_parse_penalty_matches(text):
    assert tpen.parse_penalty(text) == jpen.parse_penalty(text)


def _bad_cases():
    w_bad = _weights()
    w_asym = w_bad.copy()
    w_asym[0, 1] += 1.0
    w_neg = w_bad.copy()
    w_neg[0, 1] = w_neg[1, 0] = -1.0
    w_nan = w_bad.copy()
    w_nan[0, 1] = w_nan[1, 0] = np.nan
    w_inf_asym = w_bad.copy()
    w_inf_asym[5, 6] = np.inf
    return [
        ("parse-empty", lambda m: m.parse_penalty(""), ValueError),
        ("parse-unknown", lambda m: m.parse_penalty("lasso"), ValueError),
        ("parse-l1-shape", lambda m: m.parse_penalty("l1:2"), ValueError),
        ("parse-bad-number", lambda m: m.parse_penalty("scad:x"),
         ValueError),
        ("lam1-negative", lambda m: m.PenaltySpec.l1(-0.1), ValueError),
        ("lam1-inf", lambda m: m.PenaltySpec.l1(np.inf), ValueError),
        ("lam2-negative", lambda m: m.PenaltySpec.l1(0.1, -1.0),
         ValueError),
        ("scad-shape", lambda m: m.PenaltySpec.scad(0.1, a=2.0), ValueError),
        ("mcp-shape", lambda m: m.PenaltySpec.mcp(0.1, gamma=1.0),
         ValueError),
        ("weights-missing", lambda m: m.PenaltySpec.weighted_l1(0.1, None),
         ValueError),
        ("weights-shape", lambda m: m.PenaltySpec.weighted_l1(
            0.1, np.ones((3, 4))), ValueError),
        ("weights-asym", lambda m: m.PenaltySpec.weighted_l1(0.1, w_asym),
         ValueError),
        ("weights-negative", lambda m: m.PenaltySpec.weighted_l1(0.1, w_neg),
         ValueError),
        ("weights-nan", lambda m: m.PenaltySpec.weighted_l1(0.1, w_nan),
         ValueError),
        ("weights-inf-pattern", lambda m: m.PenaltySpec.weighted_l1(
            0.1, w_inf_asym), ValueError),
        ("as-penalty-no-lam1", lambda m: m.as_penalty("scad"), TypeError),
        ("as-penalty-spec-and-lam1", lambda m: m.as_penalty(
            m.PenaltySpec.l1(0.1), lam1=0.2), ValueError),
        ("as-penalty-weights-string", lambda m: m.as_penalty(
            "weighted_l1", lam1=0.1), ValueError),
        ("as-penalty-weights-on-scad", lambda m: m.as_penalty(
            "scad", lam1=0.1, weights=np.ones((2, 2))), ValueError),
        ("normalize-no-lam1", lambda m: m.normalize_penalty(None),
         TypeError),
        ("normalize-both", lambda m: m.normalize_penalty(
            m.PenaltySpec.l1(0.1), 0.2), ValueError),
    ]


@pytest.mark.parametrize("case", _bad_cases(), ids=lambda c: c[0])
def test_validation_errors_match(case):
    _, call, exc = case
    with pytest.raises(exc):
        call(jpen)
    with pytest.raises(exc):
        call(tpen)


@pytest.mark.parametrize("args", [
    dict(penalty=None, lam1=0.2, lam2=0.1),
    dict(penalty="scad:3.1", lam1=0.2, lam2=None),
    dict(penalty=0.3),
], ids=["legacy-floats", "string", "bare-number"])
def test_as_penalty_forms_match(args):
    js, ts = jpen.as_penalty(**args), tpen.as_penalty(**args)
    assert (ts.kind, ts.label()) == (js.kind, js.label())
    assert float(ts.lam1) == float(js.lam1)
    assert float(ts.lam2) == float(js.lam2)


def test_kernel_ok_mirrors_pallas_ok():
    for kind in KINDS:
        js, ts = _specs(kind)
        assert ts.kernel_ok == js.pallas_ok


# ---------------------------------------------------------------------------
# objective
# ---------------------------------------------------------------------------

def _omega_w(seed=6):
    rng = np.random.default_rng(seed)
    a = 0.1 * rng.standard_normal((P, P))
    om = 0.5 * (a + a.T) + np.eye(P) * 1.5
    w = rng.standard_normal((P, P))
    x = rng.standard_normal((40, P))
    s = x.T @ x / 40
    return om, w, x, s


def test_soft_threshold_and_offdiag_prox_bit_equal(x64):
    z = _z(7)
    np.testing.assert_array_equal(
        tobj.soft_threshold(torch.as_tensor(z), 0.3).numpy(),
        np.asarray(jobj.soft_threshold(jnp.asarray(z), 0.3)))
    np.testing.assert_array_equal(
        tobj.prox_l1_offdiag(torch.as_tensor(z), 0.3).numpy(),
        np.asarray(jobj.prox_l1_offdiag(jnp.asarray(z), 0.3)))


def test_gradient_bit_equal(x64):
    om, w, _, _ = _omega_w()
    np.testing.assert_array_equal(
        tobj.gradient_from_w(torch.as_tensor(om), torch.as_tensor(w),
                             0.05).numpy(),
        np.asarray(jobj.gradient_from_w(jnp.asarray(om), jnp.asarray(w),
                                        0.05)))


def test_objectives_match(x64):
    om, w, x, s = _omega_w()
    to, tw, tx, ts = (torch.as_tensor(v) for v in (om, w, x, s))
    jo, jw, jx, js = (jnp.asarray(v) for v in (om, w, x, s))
    pairs = [
        (tobj.smooth_objective_cov(to, tw, 0.05),
         jobj.smooth_objective_cov(jo, jw, 0.05)),
        (tobj.smooth_objective_obs(to, to @ tx.T, 40, 0.05),
         jobj.smooth_objective_obs(jo, jo @ jx.T, 40, 0.05)),
        (tobj.full_objective_cov(to, ts, 0.2, 0.05),
         jobj.full_objective_cov(jo, js, 0.2, 0.05)),
        (tobj.full_objective_obs(to, tx, 0.2, 0.05),
         jobj.full_objective_obs(jo, jx, 0.2, 0.05)),
        (tobj.offdiag_l1(to), jobj.offdiag_l1(jo)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


def test_sufficient_decrease_matches(x64):
    om, w, _, _ = _omega_w()
    om2 = om + 0.01
    grad = np.array(jobj.gradient_from_w(jnp.asarray(om), jnp.asarray(w),
                                           0.05))
    for g_new in (0.0, 1e3, -1e3):
        want = bool(jobj.sufficient_decrease(g_new, 1.0, jnp.asarray(om2),
                                             jnp.asarray(om),
                                             jnp.asarray(grad), 0.5))
        got = bool(tobj.sufficient_decrease(
            torch.tensor(g_new, dtype=torch.float64), 1.0,
            torch.as_tensor(om2), torch.as_tensor(om),
            torch.as_tensor(grad), 0.5))
        assert got == want
