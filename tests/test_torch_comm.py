"""The port's 1.5D communication layer (``repro_torch.comm``) on the CPU.

Ranks are spawned processes joined over gloo (``test_torch_ranks.RankPool``).

  * the six products and the two masked ones against numpy in float64 at
    1e-12, on the reference test's grids (``tests/test_comm_distributed.py``)
    cut from P = 16 to P = 4 and P = 8;
  * the exact volume model (``core.costmodel.comm_volume``) against the
    reference's on every row of ``results/BENCH_comm_volume.json``;
  * the bytes the collective wrappers announce while each product runs
    equal its declared volume at P = 4 — the paper's communication-
    avoiding claim, checked at run time;
  * the grid's permutation tables and ``best_grid`` against the
    reference's.
"""
import json
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

from repro.comm import grid as jgrid
from repro.comm import matmul1p5d as jmm
from repro.comm import sparse1p5d as jsp
from repro.core import costmodel as jcost
from repro_torch.comm import grid as tgrid
from repro_torch.comm import matmul1p5d as tmm
from repro_torch.comm import sparse1p5d as tsp
from repro_torch.core import costmodel as tcost

import test_torch_ranks as td
from test_torch_ranks import RankPool

REPO = Path(__file__).resolve().parents[1]
AGREE = 1e-12

#: the reference's grid list (tests/test_comm_distributed.py:18) at
#: P = 16, cut to what a few CPU cores run quickly: P = 4 and P = 8
GRIDS = [(4, 1, 1), (4, 2, 2), (4, 4, 1), (4, 1, 4), (4, 2, 1), (4, 1, 2),
         (8, 2, 2), (8, 4, 2), (8, 2, 4), (8, 8, 1), (8, 1, 8)]


@pytest.fixture(scope="module")
def pools():
    """One gloo rank pool per world size, started on first use."""
    made = {}

    def get(world):
        if world not in made or not made[world].alive:
            made[world] = RankPool(world)
        return made[world]
    yield get
    for pool in made.values():
        pool.close()


def _gid(g):
    return "P{}-cx{}-co{}".format(*g)


@pytest.mark.parametrize("g", GRIDS, ids=_gid)
def test_products_match_numpy(pools, g):
    P = g[0]
    # the reference test's p = 48, padded so that the mask block 4
    # divides every shard width (blk_x, blk_om) of every grid
    p, n = -(-48 // (4 * P)) * 4 * P, 8
    res = pools(P).run(td.products, *g, p, n, 0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, p))
    om = rng.standard_normal((p, p))
    s = x.T @ x / n
    want = {"xtx": s, "omega_s": om @ s, "omega_xt": om @ x.T,
            "y_x": om @ x.T @ x / n}
    out = res[0]
    for r in res[1:]:                   # every rank holds the same result
        for k in out:
            np.testing.assert_array_equal(r[k], out[k])
    for k, v in want.items():
        np.testing.assert_allclose(out[k], v, rtol=0, atol=AGREE, err_msg=k)
    np.testing.assert_allclose(out["transpose_xlike"], out["omega_s"].T,
                               rtol=0, atol=0)
    np.testing.assert_allclose(out["transpose_omegalike"], out["y_x"].T,
                               rtol=0, atol=0)
    np.testing.assert_array_equal(out["xt_rows"], x.T)
    oms = out["oms"]
    for flavor, ref in (("omega_s", oms @ s), ("omega_xt", oms @ x.T)):
        np.testing.assert_allclose(out[f"{flavor}_masked"],
                                   out[f"{flavor}_dense"], rtol=0,
                                   atol=AGREE, err_msg=flavor)
        np.testing.assert_allclose(out[f"{flavor}_masked"], ref, rtol=0,
                                   atol=AGREE, err_msg=flavor)


def _bench_rows():
    data = json.loads((REPO / "results" / "BENCH_comm_volume.json")
                      .read_text())
    return data["rows"]


@pytest.mark.parametrize("row", _bench_rows(),
                         ids=lambda r: "{flavor}-P{P}-cx{c_x}-co{c_omega}-"
                                       "{dtype}".format(**r))
def test_comm_volume_matches_the_reference_rows(row):
    """Exact Fractions, on each of the 62 recorded rows; the two
    collectives' rows at the reference's traced sizes (10 and 24
    elements over a ring of 4)."""
    flavor = row["flavor"]
    if flavor == "ring_allreduce_int8":
        got = tcost.ring_allreduce_int8_volume(10, row["P"])
        want = jcost.ring_allreduce_int8_volume(10, row["P"])
    elif flavor == "compressed_psum_bf16":
        got = tcost.compressed_psum_volume(24, row["P"])
        want = jcost.compressed_psum_volume(24, row["P"])
    else:
        base = flavor.removesuffix("_masked")
        kw = dict(flavor=base, dtype=row["dtype"],
                  masked=flavor.endswith("_masked") and base == "omega_s",
                  block_size=2)
        args = (row["p"], row["n"], row["P"], row["c_x"], row["c_omega"])
        tv, jv = tcost.comm_volume(*args, **kw), jcost.comm_volume(*args, **kw)
        assert (tv.rounds, tv.ring_bytes, tv.finish_bytes) == \
            (jv.rounds, jv.ring_bytes, jv.finish_bytes)
        assert tv.rounds == row["rounds"]
        assert str(tv.ring_bytes) == row["ring_bytes"]
        got, want = tv.total, jv.total
    assert got == want == Fraction(row["analytic_bytes"])


P4 = [g for g in GRIDS if g[0] == 4]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("g", P4, ids=_gid)
def test_watched_bytes_equal_the_declared_volume(pools, g, dtype):
    """Every product posts exactly ``comm_volume`` bytes (per process,
    critical path), dense and masked, and only the collective kinds its
    contract declares."""
    P, cx, co = g
    p, n, bs = 32, 6, 4
    res = pools(P).run(td.product_bytes, *g, p, n, dtype, bs)
    params = dict(p=p, n=n, n_devices=P, c_x=cx, c_omega=co, dtype=dtype)
    contracts = {
        "xtx": tmm.COMM_CONTRACT["xtx_local"],
        "omega_s": tmm.COMM_CONTRACT["omega_s_local"],
        "y_x": tmm.COMM_CONTRACT["y_x_local"],
        "omega_xt": tmm.COMM_CONTRACT["omega_xt_local"],
        "omega_s_masked": tsp.COMM_CONTRACT["omega_s_local_sparse"],
        "omega_xt_masked": tsp.COMM_CONTRACT["omega_xt_local_sparse"],
    }
    for events_by_flavor in res:
        assert events_by_flavor == res[0]   # the same schedule everywhere
        for name, events in events_by_flavor.items():
            total = sum(Fraction(b) for _, _, b in events)
            if name == "omega_s_xlike":
                want = tcost.comm_volume(**params, flavor="omega_s",
                                         canonical="xlike").total
                kinds = contracts["omega_s"].kinds
            else:
                contract = contracts[name]
                kw = dict(params, block_size=bs) if "masked" in name \
                    else params
                want = contract.expected_volume(kw)
                kinds = contract.kinds
                base = name.removesuffix("_masked")
                assert want == tcost.comm_volume(
                    **params, flavor=base, block_size=bs,
                    masked=name == "omega_s_masked").total
            assert total == want, (name, total, want)
            assert {prim for prim, _, _ in events} <= set(kinds), name


def test_dispatch_posts_no_collective_on_unequal_density(pools):
    """Rank-local branches post no collective: at P = 4 with c_x = 4 each
    rank multiplies one Omega block, dense on one rank and nearly empty
    on the others, so the matops dispatch goes dense on one rank and
    block-sparse on the rest; every rank still posts the same collectives
    and the product is exact."""
    res = pools(4).run(td.unequal_density, 4, 4, 1, 32, 4)
    tiles = [r["sparse_tiles"] for r in res]
    assert 0 in tiles and max(tiles) > 0, tiles
    for r in res:
        assert r["events"] == res[0]["events"]
        np.testing.assert_allclose(r["masked"], r["dense"], rtol=0,
                                   atol=AGREE)
        np.testing.assert_allclose(r["masked"], r["want"], rtol=0,
                                   atol=AGREE)


@pytest.mark.parametrize("g", GRIDS + [(16, 2, 2), (16, 4, 2), (16, 1, 16)],
                         ids=_gid)
def test_grid_tables_match_the_reference(g):
    tg, jg = tgrid.Grid1p5D(*g), jgrid.Grid1p5D(*g)
    assert tg.mesh_shape() == jg.mesh_shape()
    assert (tg.n_x, tg.n_om, tg.rounds, tg.pad_p(50)) == \
        (jg.n_x, jg.n_om, jg.rounds, jg.pad_p(50))
    for f in range(g[0]):
        assert tg.flat_to_coords(f) == jg.flat_to_coords(f)
        assert tg.flat_to_omajor(f) == jg.flat_to_omajor(f)
        assert tg.omajor_to_flat(f) == jg.omajor_to_flat(f)
    # the staggers the products use: xtx / omega_s (xlike), omega_s
    # (omegalike), y_x / omega_xt (the omega ring)
    for canon, ring, n_r in (("xlike", "x", tg.n_x),
                             ("omegalike", "x", tg.n_om),
                             ("xlike", "omega", tg.n_x)):
        assert tg.stagger_perm(canon, ring, n_r) == \
            jg.stagger_perm(canon, ring, n_r)
    for ring in ("x", "omega"):
        for shift in (1, g[1], g[2]):
            assert tg.shift_perm(ring, shift) == jg.shift_perm(ring, shift)


@pytest.mark.parametrize("P,p,n,d", [(8, 1000, 200, 5.0), (16, 4096, 512,
                                                           3.0)])
def test_best_grid_and_crossover_match_with_the_same_machine(P, p, n, d):
    jm = jcost.Machine()
    tm = tcost.Machine(**{k: getattr(jm, k) for k in (
        "name", "peak_flops", "hbm_bw", "link_bw", "msg_overhead",
        "hbm_bytes", "word_bytes")})
    for variant in ("cov", "obs"):
        assert tgrid.best_grid(P, p, n, d, variant=variant, machine=tm) == \
            tgrid.Grid1p5D(**vars(jgrid.best_grid(P, p, n, d,
                                                  variant=variant,
                                                  machine=jm)))
    shape = (p, n, d)
    assert tcost.cov_is_cheaper(tcost.ProblemShape(*shape)) == \
        jcost.cov_is_cheaper(jcost.ProblemShape(*shape))


def test_contracts_declare_the_reference_schedules():
    for port, ref in ((tmm.COMM_CONTRACT, jmm.COMM_CONTRACT),
                      (tsp.COMM_CONTRACT, jsp.COMM_CONTRACT)):
        assert port.keys() == ref.keys()
        for name in port:
            a, b = port[name], ref[name]
            assert (a.axes, a.kinds, a.wire, a.volume_class) == \
                (b.axes, b.kinds, b.wire, b.volume_class)
    params = dict(p=32, n=12, n_devices=8, c_x=2, c_omega=2,
                  dtype="float64")
    for name in tmm.COMM_CONTRACT:
        assert tmm.COMM_CONTRACT[name].expected_volume(params) == \
            jmm.COMM_CONTRACT[name].expected_volume(params)
        assert tmm.COMM_CONTRACT[name].expected_rounds(params) == \
            jmm.COMM_CONTRACT[name].expected_rounds(params)
    for name in tsp.COMM_CONTRACT:
        kw = dict(params, block_size=4)
        assert tsp.COMM_CONTRACT[name].expected_volume(kw) == \
            jsp.COMM_CONTRACT[name].expected_volume(kw)
