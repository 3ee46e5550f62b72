"""The port's Lemma 3.1-3.5 cost model and tuner (``repro_torch.core.
costmodel``) against the reference's (``repro.core.costmodel``) at the
paper's machine, EDISON, and at the port's H100 constants: every
(shape, P, c_x, c_omega, variant) case, the feasible configurations, the
tuner's choice and the Lemma 3.1 crossover, all exactly equal."""
import dataclasses
import itertools

import pytest

from repro.core import costmodel as ref
from repro_torch.core import costmodel as port

#: problem shapes (p, n, d, s, t): the paper's regimes (n << p and
#: n > p, sparse and dense iterates) at the sizes of its figures
SHAPES = [
    (1000, 100, 10, 20, 5.0),
    (40000, 10000, 2, 30, 10.0),
    (40000, 100, 60, 30, 10.0),
    (1000, 2000, 900, 30, 10.0),
    (16384, 1200, 8.5, 30, 10.0),
    (131072, 4096, 30.0, 40, 7.5),
]
PROCS = [1, 4, 16, 64, 256, 1024]

_FIELDS = ("variant", "c_x", "c_omega", "flops", "messages", "words",
           "mem_words", "t_compute", "t_latency", "t_bandwidth", "total")


def _shape(mod, p, n, d, s, t):
    return mod.ProblemShape(p=p, n=n, d=d, s=s, t=t)


def _machines():
    """(port machine, reference machine) pairs at equal constants."""
    h100 = ref.Machine(**{f.name: getattr(port.H100, f.name)
                          for f in dataclasses.fields(port.H100)})
    return {"edison": (port.EDISON, ref.EDISON), "h100": (port.H100, h100)}


def _row(cb) -> tuple:
    return tuple(getattr(cb, f) for f in _FIELDS)


def test_edison_is_the_reference_machine():
    mine = {f.name: getattr(port.EDISON, f.name)
            for f in dataclasses.fields(port.EDISON)}
    theirs = {f.name: getattr(ref.EDISON, f.name)
              for f in dataclasses.fields(ref.EDISON)}
    assert mine == theirs
    assert (port.EDISON.gamma, port.EDISON.alpha, port.EDISON.beta) == (
        ref.EDISON.gamma, ref.EDISON.alpha, ref.EDISON.beta)


@pytest.mark.parametrize("machine", ["edison", "h100"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "p%d-n%d" % s[:2])
@pytest.mark.parametrize("variant", ["cov", "obs"])
def test_lemma_costs_equal_the_reference(variant, shape, machine):
    """cov_costs / obs_costs at every P and every (c_x, c_omega) with
    c_x c_omega <= P: F, L, W, M and the three time terms, exactly."""
    mp, mr = _machines()[machine]
    fp = port.cov_costs if variant == "cov" else port.obs_costs
    fr = ref.cov_costs if variant == "cov" else ref.obs_costs
    sp, sr = _shape(port, *shape), _shape(ref, *shape)
    n = 0
    for P in PROCS:
        divs = [c for c in range(1, P + 1) if P % c == 0]
        for cx, co in itertools.product(divs, divs):
            if cx * co > P:
                continue
            assert _row(fp(sp, P, cx, co, mp)) == _row(fr(sr, P, cx, co,
                                                          mr)), (P, cx, co)
            n += 1
    assert n > 100


@pytest.mark.parametrize("machine", ["edison", "h100"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "p%d-n%d" % s[:2])
def test_enumerate_configs_and_tune_equal_the_reference(shape, machine):
    """The feasible set under the memory cap, in order, and the tuner's
    pick (or its refusal) at every P, for both variants and each alone."""
    mp, mr = _machines()[machine]
    sp, sr = _shape(port, *shape), _shape(ref, *shape)
    for P, variants in itertools.product(PROCS, [("cov", "obs"), ("cov",),
                                                 ("obs",)]):
        got = [_row(c) for c in port.enumerate_configs(sp, P, mp, variants)]
        want = [_row(c) for c in ref.enumerate_configs(sr, P, mr, variants)]
        assert got == want, (P, variants)
        if want:
            assert _row(port.tune(sp, P, mp, variants)) == _row(
                ref.tune(sr, P, mr, variants))
        else:
            with pytest.raises(ValueError):
                port.tune(sp, P, mp, variants)


@pytest.mark.parametrize("shape", SHAPES + [
    (40000, 10000, 200, 30, 10.0), (500, 499, 1, 30, 10.0),
    (500, 10, 0.4, 30, 10.0), (500, 10, 0.5, 30, 1.0)],
    ids=lambda s: "p%d-n%d-d%s-t%s" % (s[0], s[1], s[2], s[4]))
def test_lemma31_crossover_equals_the_reference(shape):
    assert port.cov_is_cheaper(_shape(port, *shape)) == \
        ref.cov_is_cheaper(_shape(ref, *shape))
