"""The dense <-> block-sparse crossover's calibration: the port's
``costmodel.calibrate_block_model`` against the reference's on the same
rows with equal machine constants (rel 1e-12), and the routing of
``sparse_matmul="auto"`` by ``CARD_BLOCK_MODEL`` on a CUDA device only
(every CPU route as before)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import costmodel as jcost
from repro_torch.core import costmodel as tcost
from repro_torch.estimator import SolverConfig
from repro_torch.estimator.backends import (DEFAULT_SPARSE_THRESHOLD,
                                            _matmul_policy)

REL = 1e-12
FIELDS = ("dense_eff", "sparse_eff", "gather_eff")


def _machines():
    """The port's H100 constants in both packages' ``Machine``."""
    return jcost.Machine(**dataclasses.asdict(tcost.H100)), tcost.H100


def _roundtrip_rows(truth, ms=None):
    """The rows of ``tests/test_matops.py``'s calibration roundtrip (p in
    1024, 2048 at m = p, block 128, five densities), timed by the port's
    model at ``truth`` on the H100 constants; ``ms`` adds other m."""
    rows = []
    for p in (1024, 2048):
        for m in ms or (p,):
            for density in (0.05, 0.1, 0.2, 0.5, 1.0):
                rows.append({
                    "p": p, "m": m, "block_size": 128, "density": density,
                    "t_dense": tcost.dense_matmul_time(p, m, model=truth),
                    "t_sparse": tcost.blocksparse_matmul_time(
                        p, m, density, 128, model=truth),
                })
    return rows


def _assert_same_model(got, want):
    for f in FIELDS:
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=REL), f


@pytest.mark.parametrize("truth", [(0.7, 0.35, 0.4), (0.85, 0.45, 0.5),
                                   (0.3, 0.9, 0.05)])
def test_calibrate_block_model_equals_the_reference(truth):
    truth = tcost.BlockSparseModel(*truth)
    jm, tm = _machines()
    rows = _roundtrip_rows(truth, ms=(None if truth.dense_eff != 0.3
                                      else (1200, 4096)))
    got = tcost.calibrate_block_model(rows)        # defaults to the H100
    _assert_same_model(got, tcost.calibrate_block_model(rows, tm))
    _assert_same_model(got, jcost.calibrate_block_model(rows, jm))
    # the roundtrip: the fitted crossover is the truth's
    for p in (1024, 2048):
        assert tcost.crossover_density(p, p, 128, model=got) == \
            pytest.approx(tcost.crossover_density(p, p, 128, model=truth),
                          rel=1e-3)


def test_calibrate_block_model_on_noisy_rows():
    """Measured-looking rows (two m, a launch intercept, noise, a row
    with no time) fit alike in both packages."""
    rng = np.random.default_rng(0)
    rows = []
    for m in (16384, 1200):
        for d in (1 / 128, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 1.0):
            t_d = 2.0 * 16384 ** 2 * m / 60e12 * rng.uniform(0.95, 1.05)
            t_s = (2e-5 + d * 2.0 * 16384 ** 2 * m / 40e12) \
                * rng.uniform(0.9, 1.1)
            rows.append({"p": 16384, "m": m, "block_size": 128,
                         "density": d, "t_dense": t_d, "t_sparse": t_s})
    rows.append({"p": 16384, "m": 1200, "block_size": 128, "density": 0.4,
                 "t_dense": 0.0, "t_sparse": 1.0})
    jm, tm = _machines()
    _assert_same_model(tcost.calibrate_block_model(rows),
                       jcost.calibrate_block_model(rows, jm))


def test_calibrate_block_model_refuses_no_rows():
    for mod in (tcost, jcost):
        with pytest.raises(ValueError, match="no usable rows"):
            mod.calibrate_block_model([{"p": 8, "m": 8, "block_size": 4,
                                        "density": 1.0, "t_dense": 0.0,
                                        "t_sparse": 1.0}])


def test_card_block_model_is_a_block_sparse_model():
    cm = tcost.CARD_BLOCK_MODEL
    assert isinstance(cm, tcost.BlockSparseModel)
    for f in FIELDS:
        assert getattr(cm, f) > 0.0
    for m in (16384, 1200):
        assert 0.0 < tcost.crossover_density(16384, m, 128, model=cm) <= 1.0


@pytest.mark.parametrize("p,m", [(16384, 16384), (16384, 1200), (512, 96)])
@pytest.mark.parametrize("cap", [None, 0.1])
def test_auto_threshold_follows_the_device(p, m, cap):
    """``"auto"``: the card's measured model on a CUDA device, the
    data-sheet model on the CPU, each capped by a user threshold."""
    cfg = SolverConfig(sparse_matmul="auto", sparse_threshold=cap)
    limit = 1.0 if cap is None else cap
    host = min(tcost.crossover_density(p, m, 128), limit)
    card = min(tcost.crossover_density(p, m, 128,
                                       model=tcost.CARD_BLOCK_MODEL), limit)
    for dev in ("cpu", torch.device("cpu")):
        pol = _matmul_policy(cfg, p, m, dev)
        assert pol.threshold == host and pol.mode == "auto"
    pol = _matmul_policy(cfg, p, m, torch.device("cuda"))
    assert pol.threshold == card and pol.block_size == 128


def test_on_and_off_ignore_the_device():
    for dev in (torch.device("cpu"), torch.device("cuda")):
        assert _matmul_policy(SolverConfig(sparse_matmul="off"), 4096, 4096,
                              dev) is None
        pol = _matmul_policy(SolverConfig(sparse_matmul="on"), 4096, 4096,
                             dev)
        assert pol.threshold == DEFAULT_SPARSE_THRESHOLD
        pol = _matmul_policy(SolverConfig(sparse_matmul="on",
                                          sparse_threshold=0.4), 4096, 4096,
                             dev)
        assert pol.threshold == 0.4
