"""The port's sharding rules, compressed collectives and the MoE's
per-shard dispatch against the JAX reference on the CPU.

  * rules: ``models.config.logical_to_spec`` on the reference's own rule
    tests (``tests/test_sharding.py``), and the specs of every parameter,
    cache leaf and batch of the ten full configs on five mesh shapes,
    entry for entry equal to the reference's (pure logic: a stand-in
    mesh with a ``.shape``, no devices);
  * collectives: ``compress_tree`` / ``decompress_tree`` bit-equal to the
    reference's; the error feedback's unbiasedness; ``compressed_psum``
    (bf16) and ``ring_allreduce_int8`` on 8 gloo ranks
    (``test_torch_ranks.RankPool``) against the reference's ``shard_map``
    outputs on 8 virtual XLA devices, and their watched wire bytes equal
    to ``core.costmodel``'s volumes;
  * MoE: ``layers.apply_moe`` inside ``batch_shards`` on 4 ranks against
    the reference's ``apply_moe`` under ``use_mesh`` on 4 virtual devices
    (out, aux and gradients), on cases where the reference's sharded and
    unsharded branches differ.

The reference's outputs come from one 8-device subprocess for the file.
"""
import subprocess
import sys
from fractions import Fraction
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.comm import collectives as jcc
from repro.models import config as jconfig
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.comm import collectives as tcc
from repro_torch.core import costmodel as tcost
from repro_torch.models import config as tconfig
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as tT

import test_torch_ranks as td
from _torch_parity import reference_env  # also pins torch to one thread
from test_torch_ranks import RankPool


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

def test_basic_mapping():
    mesh = FakeMesh({"data": 16, "model": 16})
    spec = tconfig.logical_to_spec(("embed", "heads"), (2560, 4096), mesh,
                                   tconfig.DEFAULT_RULES)
    assert spec == ("data", "model")


def test_indivisible_falls_back_to_replicated():
    mesh = FakeMesh({"data": 16, "model": 16})
    spec = tconfig.logical_to_spec(("embed", "kv"), (2560, 2 * 128), mesh,
                                   tconfig.DEFAULT_RULES)
    assert spec == ("data", "model")
    spec2 = tconfig.logical_to_spec(("embed", "kv"), (2560, 250), mesh,
                                    tconfig.DEFAULT_RULES)
    assert spec2[1] is None


def test_axis_never_used_twice():
    mesh = FakeMesh({"data": 4, "model": 4})
    spec = tconfig.logical_to_spec(("embed", "embed"), (16, 16), mesh,
                                   tconfig.DEFAULT_RULES)
    assert spec[0] == "data" and spec[1] is None


def test_kv_seq_fallback_order():
    """Decode cache: batch takes pod+data, kv takes model -> kv_seq
    replicated; when kv cannot shard, kv_seq picks up model; at batch 1
    kv_seq takes every axis."""
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    rules = tconfig.DEFAULT_RULES
    assert tconfig.logical_to_spec(("batch", "kv", "kv_seq"),
                                   (128, 32, 32768), mesh, rules) == \
        (("pod", "data"), "model", None)
    assert tconfig.logical_to_spec(("batch", "kv", "kv_seq"),
                                   (128, 2, 32768), mesh, rules) == \
        (("pod", "data"), None, "model")
    spec3 = tconfig.logical_to_spec(("batch", "kv", "kv_seq"),
                                    (1, 2, 524288), mesh, rules)
    assert spec3[0] is None and spec3[2] == ("pod", "data", "model")


SWEEP_MESHES = {
    "d16m16": {"data": 16, "model": 16},
    "p2d16m16": {"pod": 2, "data": 16, "model": 16},
    "d2m2": {"data": 2, "model": 2},
    "d4m1": {"data": 4, "model": 1},
    "d1m4": {"data": 1, "model": 4},
}
#: the cache's batch and length (the reference's decode cells' scale)
CACHE_B, CACHE_LEN, MAX_LEN = 128, 32768, 448


def _ref_spec(lg, shape, mesh, rules):
    return tuple(jconfig.logical_to_spec(lg, tuple(shape), mesh, rules))


@pytest.mark.parametrize("mesh_name", sorted(SWEEP_MESHES))
@pytest.mark.parametrize("name", jconfigs.ARCHS)
def test_specs_equal_the_reference_on_full_configs(name, mesh_name):
    """Every parameter's, cache leaf's and batch field's spec of the full
    config on the mesh: the port's (``param_shardings`` per layer,
    ``cache_shardings``, ``batch_shardings``) equal to the reference's
    ``logical_to_spec`` on the reference's logical axes and shapes."""
    mesh = FakeMesh(SWEEP_MESHES[mesh_name])
    jcfg, tcfg = jconfigs.get(name), tconfigs.get(name)
    rules = jcfg.rules()
    assert tcfg.rules() == rules
    logical = jT.logical_axes(jcfg, MAX_LEN)
    assert tT.logical_axes(tcfg, MAX_LEN) == logical
    shapes = jax.eval_shape(lambda: jT.init_params(
        jcfg, jax.random.PRNGKey(0), MAX_LEN))
    got = tlm.param_shardings(tcfg, mesh, MAX_LEN)
    stacked = tT.stacked_groups(tcfg)
    n = 0
    for group, leaves in logical.items():
        for k, lg in leaves.items():
            want = _ref_spec(lg, shapes[group][k].shape, mesh, rules)
            assert tconfig.logical_to_spec(
                lg, shapes[group][k].shape, mesh, rules) == want
            if group in stacked:
                assert len(got[group]) == stacked[group]
                assert all(layer[k] == want[1:] for layer in got[group]), \
                    (group, k)
            else:
                assert got[group][k] == want, (group, k)
            n += 1
    assert n == sum(len(v) for v in logical.values())

    cache_lg = jT.cache_logical_axes(jcfg)
    assert tT.cache_logical_axes(tcfg) == cache_lg
    cshapes = jax.eval_shape(lambda: jT.init_cache(jcfg, CACHE_B, CACHE_LEN))
    tcache = tlm.cache_shardings(tcfg, mesh, CACHE_B, CACHE_LEN)

    def walk(lg, sh, got):
        if isinstance(lg, dict):
            assert set(got) == set(lg)
            for k in lg:
                walk(lg[k], sh[k], got[k])
        else:
            assert got == _ref_spec(lg, sh.shape, mesh, rules)
    walk(cache_lg, cshapes, tcache)

    big = (1 << 30,) * 3
    tb = tlm.batch_shardings(tcfg, mesh)
    assert tb.tokens == tb.targets == _ref_spec(("batch", "seq"), big[:2],
                                                mesh, rules)
    if jcfg.enc_dec:
        assert tb.frames == _ref_spec(("batch", "seq", "embed"), big, mesh,
                                      rules)
    else:
        assert tb.frames is None


# ---------------------------------------------------------------------------
# the reference's outputs (one 8-device subprocess)
# ---------------------------------------------------------------------------

WORLD = 8
#: MoE cases: (id, mesh shape, B, L); "rows" cases split the batch rows
#: over the data team, the others have rows that do not divide it
MOE_CASES = [
    ("4x1-rows", (4, 1), 4, 128),
    ("2x2-rows", (2, 2), 4, 128),
    ("4x1-replicated", (4, 1), 2, 256),
    ("2x2-replicated", (2, 2), 3, 128),
]
#: f32 out / aux / gradients of the MoE layer across the packages
MOE_TOL = 5e-5
#: the reference's sharded and unsharded outputs must differ by more
BRANCH_GAP = 1e-4
#: the collectives across the packages, relative to max |expected|
COLL_TOL = 1e-6


def _coll_inputs():
    rng = np.random.default_rng(0)
    return {"psum": rng.standard_normal((WORLD, 64)).astype(np.float32),
            "ring": None,
            "ring_pad": rng.standard_normal((WORLD, 10)).astype(np.float32)}


def _moe_inputs(b, length, seed):
    """Layer weights of the OLMoE smoke config and an input whose first
    row leans toward expert 0: its block overflows that expert's slice of
    the capacity, where the whole batch's capacity holds nearly all."""
    cfg = jconfigs.get_smoke("olmoe_1b_7b")
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    rng = np.random.default_rng(seed)
    p = {"moe_router": rng.standard_normal((d, e)) / np.sqrt(d),
         "moe_wg": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "moe_wu": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "moe_wd": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    lean = p["moe_router"][:, 0]
    x = rng.standard_normal((b, length, d))
    x[0] += 3.0 * lean / np.linalg.norm(lean)
    w = rng.standard_normal((b, length, d))
    return p, x.astype(np.float32), w.astype(np.float32)


_REFERENCE = """
import sys, warnings
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import configs
from repro.comm.collectives import compressed_psum, ring_allreduce_int8
from repro.comm.compat import make_mesh, shard_map, use_mesh
from repro.models import layers
warnings.simplefilter("ignore")
inp, out_path = np.load(sys.argv[1]), sys.argv[2]
out = {}
mesh = make_mesh((8,), ("d",))
def psum_bf16(xs):
    return compressed_psum({"g": xs}, "d", method="bf16")[0]["g"]
def ring(xs):
    return ring_allreduce_int8(xs[0], "d")[None]
for name, fn in (("psum", psum_bf16), ("ring", ring), ("ring_pad", ring)):
    x = jnp.asarray(inp["coll/" + name])
    with use_mesh(mesh):
        out["coll/" + name] = np.asarray(shard_map(
            fn, mesh=mesh, in_specs=P("d"), out_specs=P("d"),
            check_vma=False)(x))
cfg = configs.get_smoke("olmoe_1b_7b").with_(dtype="float32")
for cid in sys.argv[3].split(","):
    shape = tuple(int(s) for s in cid.split("-")[0].split("x"))
    p = {k.split("/")[-1]: jnp.asarray(inp[k]) for k in inp.files
         if k.startswith(f"moe/{cid}/moe_")}
    x, w = jnp.asarray(inp[f"moe/{cid}/x"]), jnp.asarray(inp[f"moe/{cid}/w"])
    def f(p, x):
        out, aux = layers.apply_moe(cfg, p, x)
        return jnp.sum(out * w) + 10.0 * aux, (out, aux)
    m = make_mesh(shape, ("data", "model"), devices=jax.devices()[:4])
    # the outputs replicated: with rows that do not divide the data axis
    # GSPMD may pick an output layout no NamedSharding can state
    rep = jax.sharding.NamedSharding(m, P())
    with use_mesh(m):
        (_, (o, a)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True), out_shardings=rep)(p, x)
    out[f"moe/{cid}/out"], out[f"moe/{cid}/aux"] = np.asarray(o), np.asarray(a)
    out[f"moe/{cid}/dx"] = np.asarray(gx)
    for k, v in gp.items():
        out[f"moe/{cid}/d_{k}"] = np.asarray(v)
    o1, _ = jax.jit(lambda p, x: layers.apply_moe(cfg, p, x))(p, x)
    out[f"moe/{cid}/out_unsharded"] = np.asarray(o1)
np.savez(out_path, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharding_ref")
    coll = _coll_inputs()
    arrays = {f"coll/{k}": v for k, v in coll.items() if v is not None}
    arrays["coll/ring"] = coll["psum"]
    for i, (cid, _, b, length) in enumerate(MOE_CASES):
        p, x, w = _moe_inputs(b, length, seed=10 + i)
        arrays.update({f"moe/{cid}/{k}": v for k, v in p.items()})
        arrays[f"moe/{cid}/x"], arrays[f"moe/{cid}/w"] = x, w
    np.savez(d / "in.npz", **arrays)
    env = reference_env(WORLD)
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(d / "in.npz"),
         str(d / "out.npz"), ",".join(c[0] for c in MOE_CASES)], env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = np.load(d / "out.npz")
    return {"in": arrays, "out": {k: out[k] for k in out.files}}


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(world):
        if world not in made or not made[world].alive:
            for other in made.values():     # one pool alive at a time
                other.close()
            made[world] = RankPool(world)
        return made[world]
    yield get
    for pool in made.values():
        pool.close()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((7, 5)).astype(np.float32),
            "b": {"c": (rng.standard_normal(9) * 1e-3).astype(np.float32)}}


def test_compress_tree_int8_bit_equal_to_the_reference():
    """Three int8 rounds with error feedback carried: q, scale, the
    residual and the decompressed tree bit-equal to the reference's
    jitted ``compress_tree`` (as it runs inside a train step: XLA divides
    by 127 as a multiplication by the reciprocal, which the port
    mirrors; the reference's eager ops divide)."""
    jstate = tstate = None
    compress = jax.jit(partial(jcc.compress_tree, method="int8"))
    for step in range(3):
        g = _tree(step)
        jp, jstate = compress(jax.tree.map(jnp.asarray, g), jstate)
        tp, tstate = tcc.compress_tree(
            {"w": torch.as_tensor(g["w"]),
             "b": {"c": torch.as_tensor(g["b"]["c"])}}, tstate,
            method="int8")
        for path in (("w",), ("b", "c")):
            jq, js = jp[path[0]] if len(path) == 1 else jp["b"]["c"]
            tq, ts = tp[path[0]] if len(path) == 1 else tp["b"]["c"]
            assert tq.dtype == torch.int8
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        np.testing.assert_array_equal(tstate.residual["w"].numpy(),
                                      np.asarray(jstate.residual["w"]))
        np.testing.assert_array_equal(tstate.residual["b"]["c"].numpy(),
                                      np.asarray(jstate.residual["b"]["c"]))
        jd = jcc.decompress_tree(jp, method="int8")
        td_ = tcc.decompress_tree(tp, method="int8")
        np.testing.assert_array_equal(td_["w"].numpy(), np.asarray(jd["w"]))


@pytest.mark.parametrize("method", ["bf16", "none"])
def test_compress_tree_bf16_and_none_bit_equal(method):
    g = _tree(4)
    jp, _ = jcc.compress_tree(jax.tree.map(jnp.asarray, g), None,
                              method=method)
    tp, _ = tcc.compress_tree({"w": torch.as_tensor(g["w"]),
                               "b": {"c": torch.as_tensor(g["b"]["c"])}},
                              None, method=method)
    jd = jcc.decompress_tree(jp, method=method)
    td_ = tcc.decompress_tree(tp, method=method)
    np.testing.assert_array_equal(td_["w"].float().numpy(),
                                  np.asarray(jd["w"], np.float32))
    np.testing.assert_array_equal(td_["b"]["c"].float().numpy(),
                                  np.asarray(jd["b"]["c"], np.float32))


def test_error_feedback_unbiased_over_time():
    """int8 + error feedback: the accumulated quantized sum converges to
    the true sum (the residual carries what quantization dropped)."""
    rng = np.random.default_rng(0)
    g = {"w": torch.as_tensor(rng.standard_normal(256).astype(np.float32))}
    state = tcc.init_error_feedback(g)
    acc_q = np.zeros(256, np.float32)
    for _ in range(50):
        payload, state = tcc.compress_tree(g, state, method="int8")
        acc_q += tcc.decompress_tree(payload, method="int8")["w"].numpy()
    acc_true = g["w"].numpy() * 50
    rel = np.abs(acc_q - acc_true).max() / np.abs(acc_true).max()
    assert rel < 0.02, rel


@pytest.mark.parametrize("kind", ["mesh", "grid"])
def test_collectives_on_8_ranks_match_the_reference(pools, reference, kind):
    """On 8 gloo ranks, on a mesh axis and on a 1.5D grid's all-rank team:
    the bf16 psum and the int8 ring (and the ring on 10 elements, padded
    to 16) within COLL_TOL of the reference's ``shard_map`` outputs on 8
    devices, inside the reference test's error bounds against the true
    sum, every rank alike; the watched wire bytes equal to the cost
    model's volumes at float32."""
    ins = reference["in"]
    inputs = {k: ins[f"coll/{k}"] for k in ("psum", "ring", "ring_pad")}
    res = pools(WORLD).run(td.collectives, kind, inputs)
    for name, bound in (("psum", 2e-2), ("ring", 0.15), ("ring_pad", 0.15)):
        want = reference["out"][f"coll/{name}"]
        expected = inputs[name].sum(axis=0)
        scale = np.abs(want).max()
        for r, got in enumerate(res):
            err = np.abs(got[name] - want[r]).max() / scale
            assert err <= COLL_TOL, (name, r, err)
            np.testing.assert_array_equal(got[name], res[0][name])
            rel = np.abs(got[name] - expected).max() / np.abs(expected).max()
            assert rel < bound, (name, rel)
    size = inputs["psum"].shape[1]
    for got in res:
        assert Fraction(got["psum_bytes"]) == tcost.compressed_psum_volume(
            size, WORLD, method="bf16")
        assert got["psum_prims"] == ["psum"]
        assert Fraction(got["ring_bytes"]) == tcost.ring_allreduce_int8_volume(
            size, WORLD, dtype="float32")
        assert Fraction(got["ring_pad_bytes"]) == \
            tcost.ring_allreduce_int8_volume(10, WORLD, dtype="float32")
        assert got["ring_prims"] == ["all_gather", "ppermute"]


def test_collective_contracts_declare_the_reference_schedules():
    """The port's ``COMM_CONTRACT`` declares the reference's schedules,
    and its volumes (float64) equal the reference's declared volumes."""
    assert tcc.COMM_CONTRACT.keys() == jcc.COMM_CONTRACT.keys()
    for name, a in tcc.COMM_CONTRACT.items():
        b = jcc.COMM_CONTRACT[name]
        assert (a.axes, a.kinds, a.wire, a.volume_class) == \
            (b.axes, b.kinds, b.wire, b.volume_class)
        for size, extent in ((10, 4), (24, 4), (64, 8), (1000, 3)):
            params = {"size": size, "extent": extent}
            assert a.expected_volume(params) == b.expected_volume(params)
            assert a.expected_rounds(params) == b.expected_rounds(params)


# ---------------------------------------------------------------------------
# the MoE's per-shard dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_per_shard_dispatch_matches_the_reference(pools, reference,
                                                      case):
    """``apply_moe`` on 4 ranks of the case's mesh: each rank's output
    rows, the aux loss, the weights' gradients (summed over the data
    team) and the input's within MOE_TOL of the reference's under
    ``use_mesh`` on 4 devices; the reference's own sharded and unsharded
    outputs differ by more than BRANCH_GAP, so the bound tells the
    branches apart; capacity drops tokens."""
    cid, shape, b, _ = case
    ins, ref = reference["in"], reference["out"]
    p = {k: ins[f"moe/{cid}/{k}"]
         for k in ("moe_router", "moe_wg", "moe_wu", "moe_wd")}
    x, w = ins[f"moe/{cid}/x"], ins[f"moe/{cid}/w"]
    want = ref[f"moe/{cid}/out"]
    gap = np.abs(want - ref[f"moe/{cid}/out_unsharded"]).max()
    assert gap > BRANCH_GAP, gap
    res = pools(4).run(td.moe_mesh, shape, p, x, w)
    rows = b % shape[0] == 0
    assert all(r["rows"] == rows for r in res)
    assert sum(r["dropped"] for r in res) > 0
    for r in res:
        lo, hi = r["lo"], r["hi"]
        np.testing.assert_allclose(r["out"], want[lo:hi], rtol=0,
                                   atol=MOE_TOL)
        assert abs(r["aux"] - float(ref[f"moe/{cid}/aux"])) <= MOE_TOL
        np.testing.assert_allclose(r["dx"], ref[f"moe/{cid}/dx"][lo:hi],
                                   rtol=0, atol=MOE_TOL)
        for k, g in r["grads"].items():
            gw = ref[f"moe/{cid}/d_{k}"]
            np.testing.assert_allclose(g, gw, rtol=0,
                                       atol=MOE_TOL * max(1.0,
                                                          np.abs(gw).max()),
                                       err_msg=k)
