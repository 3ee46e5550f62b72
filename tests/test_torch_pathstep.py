"""The fused path step's plain version (the CPU route of
``kernels.ops.fused_path_step``) against the JAX package: the oracle
``repro.kernels.ref.fused_path_step`` and the Pallas kernel in interpret
mode, at every manifest config and at the tile sizes of the reference's
own bitwise test.

``cand`` is bit-exact against the oracle run op by op (every operation
rounded, as torch and the CUDA kernel built with ``-fmad=false`` round
it). Under ``jax.jit`` — and so in interpret mode — XLA:CPU contracts
``omega - tau * grad`` into one fused multiply-add, which moves ~a
quarter of the entries of z by one ulp; the threshold then subtracts
exactly, so against those ``cand`` is held to ``FMA_ATOL`` (an ulp or
two at the magnitudes here, |z| < 4). The five per-lane stats are sums
taken in another order, held at rtol 1e-12 in float64 (the reference's
bar for its kernel against its oracle). The CUDA kernel is held against
this plain version on the card in ``test_torch_kernels_gpu.py``."""
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import manifest as tman
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pathstep as tps

from _torch_parity import x64  # noqa: F401

ENTRY = tman.entry("fused_path_step")
STATS_RTOL = ENTRY["rtol"]["float64"]
FMA_ATOL = 4 * np.finfo(np.float64).eps


def _both(args, weights):
    """(port cand, port stats) on CPU tensors and the numpy inputs."""
    om, w, tau, lam1, lam2 = (torch.as_tensor(a) for a in args)
    wt = None if weights is None else torch.as_tensor(weights)
    return tops.fused_path_step(om, w, tau, lam1, lam2, weights=wt)


def _assert_matches(got, want, *, fused: bool):
    """``fused``: ``want`` ran under jit, where XLA contracts the
    multiply-add of ``z``; otherwise bit-exact."""
    cand, stats = got
    if fused:
        np.testing.assert_allclose(cand.numpy(), np.asarray(want[0]),
                                   rtol=0, atol=FMA_ATOL)
    else:
        np.testing.assert_array_equal(cand.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(stats.numpy(), np.asarray(want[1]),
                               rtol=STATS_RTOL, atol=0)


@pytest.mark.parametrize("cfg", ENTRY["configs"], ids=lambda c: c["label"])
def test_plain_matches_jax_oracle_and_interpret_kernel(x64, cfg):
    rng = np.random.default_rng(zlib.crc32(cfg["label"].encode()))
    *args, weights = tman.pathstep_problem(cfg, rng)
    jargs = [jnp.asarray(a) for a in args]
    jw = None if weights is None else jnp.asarray(weights)
    got = _both(args, weights)
    _assert_matches(got, jref.fused_path_step(*jargs, weights=jw),
                    fused=False)
    _assert_matches(got, jax.jit(jref.fused_path_step)(*jargs, weights=jw),
                    fused=True)
    _assert_matches(got, jops.fused_path_step(
        *jargs, weights=jw, block=cfg["block"], interpret=True), fused=True)
    assert got[1].shape == (cfg["c"], 5)
    assert got[1].dtype == torch.float64


def _kernel_case(c=3, p=24, seed=0):
    """The inputs of the reference's ``_kernel_case``."""
    rng = np.random.default_rng(seed)
    omega = np.eye(p) + 0.1 * rng.standard_normal((c, p, p))
    w = rng.standard_normal((c, p, p))
    return (omega, w, np.geomspace(0.5, 1.5, c), np.linspace(0.1, 0.3, c),
            np.linspace(0.0, 0.1, c))


@pytest.mark.parametrize("block", [8, 12, 24])
def test_plain_matches_interpret_kernel_at_reference_blocks(x64, block):
    args = _kernel_case()
    jargs = [jnp.asarray(a) for a in args]
    got = _both(args, None)
    _assert_matches(got, jref.fused_path_step(*jargs), fused=False)
    _assert_matches(got, jops.fused_path_step(*jargs, block=block,
                                              interpret=True), fused=True)
    stats = got[1].numpy()
    assert np.all(stats[:, 1] >= 0)          # <diff, diff>
    assert np.all(stats[:, 4] >= 24)         # the diagonal never thresholds


def test_inf_weights_force_zeros_in_a_zero_lam1_lane(x64):
    """tau * lam1 = 0 in lane 0: finite weights leave z unthresholded,
    inf weights still force exact zeros (inf * 0 would be nan)."""
    cfg = next(c for c in ENTRY["configs"] if c.get("zero_lam1_lane"))
    *args, weights = tman.pathstep_problem(cfg, np.random.default_rng(3))
    assert args[2][0] == 0.0 or args[3][0] == 0.0
    cand, stats = _both(args, weights)
    want = jref.fused_path_step(*(jnp.asarray(a) for a in args),
                                weights=jnp.asarray(weights))
    _assert_matches((cand, stats), want, fused=False)
    off = ~np.eye(cfg["p"], dtype=bool)
    lane0 = cand[0].numpy()
    assert np.all(lane0[np.isinf(weights[0]) & off] == 0.0)
    assert not np.isnan(cand.numpy()).any()
    assert not np.isnan(stats.numpy()).any()


def test_shared_weight_matrix_equals_per_lane_copies(x64):
    """A shared (p, p) weight matrix (the engine's form for a spec with
    one weight matrix) gives what C copies of it give."""
    *args, _ = tman.pathstep_problem({"c": 3, "p": 10},
                                     np.random.default_rng(4))
    w = np.abs(np.random.default_rng(5).standard_normal((10, 10))) + 0.1
    w[0, 3] = w[3, 0] = np.inf
    shared = _both(args, w)
    stacked = _both(args, np.broadcast_to(w, (3, 10, 10)).copy())
    for a, b in zip(shared, stacked):
        assert torch.equal(a, b)


def test_cpu_calls_are_not_counted_and_the_kernel_refuses_cpu():
    tops.reset_launches()
    args = [torch.as_tensor(a) for a in _kernel_case(c=2, p=8)]
    tops.fused_path_step(*args)
    assert tops.LAUNCHES["fused_path_step"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tps.fused_path_step(*args)
