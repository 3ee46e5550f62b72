"""The port's matops layer against the reference: occupancy masks,
capacity tiers, and the dispatch's rung choice at every tier boundary."""
import bisect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import matops as jm
from repro_torch.core import matops as tm

from _torch_parity import x64  # noqa: F401


def _sparse(p, k, bs, density, seed):
    rng = np.random.default_rng(seed)
    nbr, nbc = -(-p // bs), -(-k // bs)
    keep = rng.random((nbr, nbc)) < density
    a = rng.standard_normal((p, k))
    a *= np.kron(keep, np.ones((bs, bs)))[:p, :k]
    # a lone nonzero in an edge tile must switch that tile on
    a[p - 1, k - 1] = 0.5
    return a


@pytest.mark.parametrize("p,k,bs", [(32, 32, 8), (40, 24, 8), (13, 13, 4),
                                    (64, 64, 16)])
def test_block_mask_matches(x64, p, k, bs):
    a = _sparse(p, k, bs, 0.4, seed=p * k)
    want = np.asarray(jm.block_mask(jnp.asarray(a), bs))
    got = tm.block_mask(torch.as_tensor(a), bs)
    assert got.dtype == tm.MASK_DTYPE == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(tm.block_density(got)) == float(jm.block_density(
        jnp.asarray(want)))
    assert tm.block_density(got).dtype == tm.DENSITY_DTYPE


@pytest.mark.parametrize("total", [1, 4, 16, 64, 100, 1024, 16384])
@pytest.mark.parametrize("threshold", [0.05, 0.25, 0.5, 1.0])
def test_capacity_tiers_match(total, threshold):
    assert tm.capacity_tiers(total, threshold) == \
        jm.capacity_tiers(total, threshold)


def test_rung_rule_matches_searchsorted():
    caps = tm.capacity_tiers(64, 0.5)
    for occupied in range(0, 66):
        ix = int(jnp.searchsorted(jnp.asarray(caps), occupied, side="left"))
        want = caps[ix] if ix < len(caps) else None
        assert tm.select_capacity(caps, occupied) == want
        assert bisect.bisect_left(caps, occupied) == ix


def _tier_cases():
    p, bs = 64, 8
    total = (p // bs) ** 2
    counts = {c for cap in jm.capacity_tiers(total, 0.5)
              for c in (cap, cap + 1)}
    return sorted(counts | {1, total - 1})


@pytest.mark.parametrize("nnz", _tier_cases())
def test_dispatch_exact_at_every_tier_capacity_boundary(x64, nnz):
    """Mirror of tests/test_matops.py's boundary test in float64: the
    rung the dispatch picks must cover every occupied block, and both
    packages agree with the dense product."""
    rng = np.random.default_rng(11 + nnz)
    p, bs = 64, 8
    total = (p // bs) ** 2
    b = rng.standard_normal((p, 48))
    a = np.zeros((p, p))
    for blk_id in rng.choice(total, size=nnz, replace=False):
        r, c = divmod(int(blk_id), p // bs)
        a[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] = \
            rng.standard_normal((bs, bs))
    jpol, tpol = jm.MatmulPolicy("on", bs, 0.5), tm.MatmulPolicy("on", bs, 0.5)
    jmask = jm.block_mask(jnp.asarray(a), bs)
    tmask = tm.block_mask(torch.as_tensor(a), bs)
    assert tm.occupied_blocks(tmask) == nnz
    want = jax.jit(lambda a_, b_, m_: jm.matmul(a_, b_, mask=m_,
                                                policy=jpol))(
        jnp.asarray(a), jnp.asarray(b), jmask)
    got = tm.matmul(torch.as_tensor(a), torch.as_tensor(b), mask=tmask,
                    policy=tpol)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-12, atol=1e-12)


def test_dispatch_routes_by_count(monkeypatch):
    """Below the last rung the sparse branch runs with the covering
    capacity; above it (and with the policy off or no mask) dense."""
    calls = []
    monkeypatch.setattr(tm, "masked_matmul",
                        lambda a, b, m, *, block_size, capacity:
                        calls.append(capacity) or a @ b)
    pol = tm.MatmulPolicy("on", 8, 0.5)
    caps = tm.capacity_tiers(64, 0.5)
    b = torch.ones((64, 4), dtype=torch.float64)
    for nnz, want in [(1, caps[0]), (caps[1], caps[1]),
                      (caps[-1] + 1, None)]:
        a = torch.zeros((64, 64), dtype=torch.float64)
        for i in range(nnz):
            r, c = divmod(i, 8)
            a[r * 8, c * 8] = 1.0
        calls.clear()
        tm.matmul(a, b, mask=tm.block_mask(a, 8), policy=pol)
        assert calls == ([] if want is None else [want])
    calls.clear()
    tm.matmul(a, b, mask=None, policy=pol)
    tm.matmul(a, b, mask=tm.block_mask(a, 8), policy=tm.DENSE)
    assert calls == []


def test_dispatch_rejects_mask_of_the_wrong_tiling():
    a = torch.zeros((16, 16), dtype=torch.float64)
    with pytest.raises(ValueError, match="does not tile"):
        tm.matmul(a, a, mask=torch.zeros((3, 3), dtype=torch.int8),
                  policy=tm.MatmulPolicy("on", 8, 0.5))


def test_policy_defaults_match():
    assert tuple(tm.MatmulPolicy()) == tuple(jm.MatmulPolicy())
    assert tm.TIER_FRACTIONS == jm.TIER_FRACTIONS
    assert not tm.DENSE.enabled and tm.MatmulPolicy("auto").enabled
