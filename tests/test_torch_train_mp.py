"""Multi-rank LM training of the port against the JAX reference on the
CPU: ``train(mesh=)`` on 4 gloo ranks (``test_torch_ranks.RankPool``)
against the reference's ``train(mesh=make_mesh(...))`` on 4 virtual XLA
devices (one subprocess for the file), the (1, 1) mesh against no mesh,
checkpoints across meshes and across the packages, and ``launch.train
--mesh``.

Both packages start from the same weights (the reference's
``init_params``, carried over with ``convert.lm_params_from_numpy``) and
draw the same batches (``make_source``, bit-equal across the packages),
in float32: the h2o-danube and OLMoE smoke configs, 3 steps of 4 x 64,
on the meshes (data, model) = (1, 4), (2, 2) and (4, 1).  On (4, 1) and
(2, 2) the MoE dispatches per data shard, and its losses part from the
one-device run's by 1e-4 to 2e-3, so the 1e-5 bound tells the branches
apart.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import transformer as jT
from repro.train import checkpoint as jckpt
from repro.train import optim as jopt
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import mesh as tmesh
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import loop as tloop
from repro_torch.train import optim as topt

import test_torch_ranks as td
from _torch_parity import reference_env  # also pins torch to one thread
from test_torch_ranks import RankPool

NAMES = ("h2o_danube_1p8b", "olmoe_1b_7b")
MESHES = ((1, 4), (2, 2), (4, 1))
SEQ, BATCH, STEPS = 64, 4, 3
KW = dict(seq_len=SEQ, global_batch=BATCH, steps=STEPS, peak_lr=1e-3,
          warmup=0, log_every=0)
#: every step's loss: float32 in two libraries over other reduction
#: orders; the reference's own spread across meshes (dense) is 5e-7
LOSS_TOL = 1e-5
#: the MoE's per-shard dispatch moves the reference's step-1 loss by
#: 6e-4 on (2, 2) and 2e-3 on (4, 1) against one device
BRANCH_GAP = 1e-4
#: the final parameters, where the reference's step-1 gradient is at
#: least SIGN_FRAC of its leaf's max or exactly zero (see
#: test_torch_lm_train.SIGN_FRAC: AdamW's first step is lr * sign(g)).
#: Steps 2 and 3 move each entry by lr (1e-3) times Adam's ratio of
#: gradients that agree up to float32 summation order: measured at most
#: 1.9e-6 on the six runs, held at PARAM_TOL.  The entries left out:
#: 1.2% on danube, 3.2-3.4% on OLMoE (each expert sees few tokens, so
#: more of its gradient is tiny), held under LEFT_OUT
SIGN_FRAC, PARAM_TOL, LEFT_OUT = 1e-3, 5e-6, 0.05


def _key(shape):
    return "none" if shape is None else "x".join(map(str, shape))


def _weights(name):
    """The reference's init at seed 0, zero leaves moved off zero."""
    cfg = jconfigs.get_smoke(name).with_(dtype="float32")
    rng = np.random.default_rng(1)
    params = jax.tree.map(np.asarray, jT.init_params(
        cfg, jax.random.PRNGKey(0), max_len=SEQ))
    return jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        if not a.any() else a, params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


_REFERENCE = """
import sys, warnings
import numpy as np, jax, jax.numpy as jnp
from repro import configs
from repro.comm.compat import use_mesh
from repro.launch.mesh import make_mesh
from repro.models import lm, transformer as T
from repro.train import loop, optim
from repro.train.data import make_source
warnings.simplefilter("ignore")
inp, out_path, root = np.load(sys.argv[1]), sys.argv[2], sys.argv[3]
kw = %(kw)r
out = {}
def nest(name):
    tree = {}
    for k in inp.files:
        if k.startswith(name + "/"):
            node = tree
            *path, leaf = k.split("/")[1:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = inp[k]
    return tree
for name in %(names)r:
    cfg = configs.get_smoke(name).with_(dtype="float32")
    params = nest(name)
    batch = make_source(cfg, kw["seq_len"], kw["global_batch"], 0)(0)
    for shape in %(meshes)r + [None]:
        key = "none" if shape is None else "x".join(map(str, shape))
        mesh = None if shape is None else make_mesh(shape, ("data", "model"))
        opt = optim.AdamW(weight_decay=0.1, clip_norm=1.0)
        state = lm.TrainState(jax.tree.map(jnp.asarray, params),
                              opt.init(params), jnp.zeros((), jnp.int32))
        tc = loop.TrainerConfig(ckpt_dir=f"{root}/{name}/{key}",
                                ckpt_every=100, **kw)
        res = loop.train(cfg, tc, mesh=mesh, state=state,
                         log=lambda *a: None)
        out[f"{name}/{key}/losses"] = np.asarray(res.losses)
        if mesh is None:
            continue
        grad = jax.jit(jax.grad(lambda p: lm.loss_fn(cfg, p, batch)[0]))
        with use_mesh(mesh):
            g = jax.tree.map(np.asarray, grad(params))
        for group, leaves in g.items():
            for k, v in leaves.items():
                out[f"{name}/{key}/grad/{group}/{k}"] = v
        shard = lm.param_shardings(cfg, mesh, max_len=kw["seq_len"])
        for group, leaves in shard.items():
            for k, s in leaves.items():
                shp = s.shard_shape(params[group][k].shape)
                out[f"{name}/{key}/shard/{group}/{k}"] = np.asarray(shp)
np.savez(out_path, **out)
print("OK")
""" % dict(kw=KW, names=NAMES, meshes=list(MESHES))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's runs in one 4-device subprocess: each (config,
    mesh)'s losses, step-1 gradient and shard shapes, and the step-3
    checkpoint (``ckpt/<name>/<mesh>``); the one-device run too."""
    d = tmp_path_factory.mktemp("train_mp_ref")
    flat = {}
    for name in NAMES:
        flat.update(_flat(_weights(name), f"{name}/"))
    np.savez(d / "in.npz", **flat)
    env = reference_env(4)
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(d / "in.npz"),
         str(d / "out.npz"), str(d / "ckpt")], env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = np.load(d / "out.npz")
    return {"out": {k: out[k] for k in out.files}, "ckpt": d / "ckpt"}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def runs(pool, tmp_path_factory):
    """The port's runs on 4 ranks, each with its step-3 checkpoint."""
    d = tmp_path_factory.mktemp("train_mp_port")
    out = {}
    for name in NAMES:
        params = _weights(name)
        for shape in MESHES:
            ckpt_dir = str(d / name / _key(shape))
            out[name, shape] = (pool.run(td.train_mesh, name, shape, params,
                                         KW, ckpt_dir), ckpt_dir)
    return out


@pytest.mark.parametrize("shape", MESHES, ids=_key)
@pytest.mark.parametrize("name", NAMES)
def test_train_on_a_mesh_matches_reference(reference, runs, name, shape):
    """Every step's loss within LOSS_TOL of the reference's on the same
    mesh, on every rank; each rank's blocks shaped as the reference's
    ``NamedSharding`` shards; the final parameters gathered whole against
    the reference's step-3 checkpoint wherever its step-1 gradient is at
    least SIGN_FRAC of the leaf's max (or zero); the MoE's losses part
    from the one-device run's by more than BRANCH_GAP."""
    ref, res = reference["out"], runs[name, shape][0]
    key = f"{name}/{_key(shape)}"
    want = ref[f"{key}/losses"]
    for r in res:
        assert r["final_step"] == STEPS
        np.testing.assert_allclose(r["losses"], want, rtol=0, atol=LOSS_TOL)
    assert len({tuple(r["losses"]) for r in res}) == 1
    if name == "olmoe_1b_7b" and shape != (1, 4):
        gap = np.abs(ref[f"{name}/none/losses"] - want).max()
        assert gap > BRANCH_GAP, gap
        assert np.abs(np.asarray(res[0]["losses"])
                      - ref[f"{name}/none/losses"]).max() > BRANCH_GAP

    # each rank's block shapes: the reference's shard shapes
    tcfg = tconfigs.get_smoke(name)
    model = convert.lm_params_from_numpy(tcfg.with_(dtype="float32"),
                                         _weights(name), device="cpu")
    names = [(g, k) for g, leaves in sorted(model.tree().items())
             for layer in (leaves if isinstance(leaves, list) else [leaves])
             for k in sorted(layer)]
    for (group, k), got in zip(names, res[0]["shapes"]):
        shp = tuple(ref[f"{key}/shard/{group}/{k}"])
        if group in ("blocks", "enc"):
            shp = shp[1:]
        assert got == shp, (group, k, got, shp)

    # the final parameters against the reference's checkpoint
    step_dir = reference["ckpt"] / name / _key(shape) / f"step_{STEPS:08d}"
    left_out = total = 0
    for group, leaves in res[0]["state"]["params"].items():
        for k, got in leaves.items():
            w = np.load(step_dir / f"params__{group}__{k}.npy")
            g = np.abs(ref[f"{key}/grad/{group}/{k}"])
            keep = (g >= SIGN_FRAC * g.max()) | (g == 0)
            left_out += int((~keep).sum())
            total += keep.size
            np.testing.assert_allclose(got[keep], w[keep], rtol=0,
                                       atol=PARAM_TOL, err_msg=f"{group}/{k}")
    assert left_out < LEFT_OUT * total, (left_out, total)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_of_one_rank_is_bit_equal_to_no_mesh(name):
    """At world size 1 the (1, 1) mesh trains exactly as ``mesh=None``:
    the losses and every leaf of the final state bit for bit (two
    micro-batches, so the accumulation runs too)."""
    cfg = tconfigs.get_smoke(name).with_(dtype="float32")
    tc = tloop.TrainerConfig(n_micro=2, **KW)
    a = tloop.train(cfg, tc, device="cpu", log=lambda *a: None)
    mesh = tmesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    b = tloop.train(cfg, tc, mesh=mesh, device="cpu", log=lambda *a: None)
    assert a.losses == b.losses
    sa = topt.tree_leaves(convert.train_state_to_numpy(a.state))
    sb = topt.tree_leaves(convert.train_state_to_numpy(b.state))
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(x, y)


def _one_process_restore(name, ckpt_dir):
    cfg = tconfigs.get_smoke(name).with_(dtype="float32")
    from repro_torch.models import lm, transformer
    state = lm.init_train_state(
        transformer.init_params(cfg, seed=5, max_len=SEQ, device="cpu"),
        topt.AdamW())
    state, manifest = tckpt.restore(ckpt_dir, state)
    return convert.train_state_to_numpy(state), manifest


def _assert_trees_equal(a, b):
    la, lb = topt.tree_leaves(a), topt.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", NAMES)
def test_checkpoint_saved_on_2x2_restores_anywhere(pool, runs, name):
    """The (2, 2) run's step-3 checkpoint (gathered to rank 0, the mesh's
    shape in the manifest) restores in one process and onto (4, 1) and
    (1, 4), leaf for leaf bit-equal to the state the run ended with;
    each rank keeps exactly its blocks."""
    res, ckpt_dir = runs[name, (2, 2)]
    whole, manifest = _one_process_restore(name, ckpt_dir)
    assert manifest["mesh_shape"] == {"data": 2, "model": 2}
    assert manifest["step"] == STEPS
    _assert_trees_equal(whole, res[0]["state"])
    for shape in ((4, 1), (1, 4)):
        back = pool.run(td.restore_mesh, name, shape, ckpt_dir, SEQ)
        assert all(b["step"] == STEPS and b["equal_blocks"] for b in back)
        _assert_trees_equal(back[0]["state"], res[0]["state"])


def test_port_checkpoint_restores_in_the_reference(runs):
    """A checkpoint the port's 4 ranks wrote on (4, 1) restores in the
    reference, leaf for leaf bit-equal to the port's own restore."""
    name = "olmoe_1b_7b"
    _, ckpt_dir = runs[name, (4, 1)]
    whole, _ = _one_process_restore(name, ckpt_dir)
    cfg = jconfigs.get_smoke(name).with_(dtype="float32")
    params = jax.eval_shape(
        lambda: jT.init_params(cfg, jax.random.PRNGKey(0), max_len=SEQ))
    template = jlm.TrainState(params, jax.eval_shape(jopt.AdamW().init,
                                                     params),
                              jax.ShapeDtypeStruct((), jnp.int32))
    state, manifest = jckpt.restore(ckpt_dir, template)
    assert manifest["mesh_shape"] == {"data": 4, "model": 1}
    got = {"params": jax.tree.map(np.asarray, state.params),
           "opt": {"step": np.asarray(state.opt.step),
                   "m": jax.tree.map(np.asarray, state.opt.m),
                   "v": jax.tree.map(np.asarray, state.opt.v)},
           "step": np.asarray(state.step)}
    _assert_trees_equal(got, whole)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=_key)
def test_reference_checkpoint_restores_on_port_ranks(pool, reference,
                                                     shape):
    """The reference's step-3 checkpoint from 4 virtual devices (its
    (4, 1) run) restores on 4 port ranks, each leaf gathered back
    bit-equal to the reference's file."""
    name = "olmoe_1b_7b"
    ref_dir = reference["ckpt"] / name / "4x1"
    back = pool.run(td.restore_mesh, name, shape, str(ref_dir), SEQ)
    assert all(b["step"] == STEPS and b["equal_blocks"] for b in back)
    step_dir = ref_dir / f"step_{STEPS:08d}"
    state = back[0]["state"]
    for group, leaves in state["params"].items():
        for k, got in leaves.items():
            for part, tree in (("params", state["params"]),
                               ("opt__m", state["opt"]["m"]),
                               ("opt__v", state["opt"]["v"])):
                want = np.load(step_dir / f"{part}__{group}__{k}.npy")
                np.testing.assert_array_equal(tree[group][k], want)


def test_launch_train_mesh_host_trains_on_1x4(pool, tmp_path):
    """``launch.train --mesh host`` inside a 4-rank group trains on the
    reference's host factoring of 4 ranks, (1, 4): every rank's losses
    equal, the checkpoint's manifest naming the mesh; rerun to more
    steps, it resumes."""
    argv = ["--arch", "olmoe-1b-7b", "--smoke", "--seq-len", "32",
            "--batch", "4", "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "2", "--mesh", "host"]
    res = pool.run(td.train_cli, argv + ["--steps", "2"])
    assert all(r["final_step"] == 2 and r["losses"] == res[0]["losses"]
               for r in res)
    _, manifest = _one_process_restore_cli(tmp_path)
    assert manifest["mesh_shape"] == {"data": 1, "model": 4}
    again = pool.run(td.train_cli, argv + ["--steps", "4"])
    assert all(r["final_step"] == 4 and len(r["losses"]) == 2
               for r in again)


def _one_process_restore_cli(ckpt_dir):
    import json
    step = tckpt.latest_step(str(ckpt_dir))
    with open(ckpt_dir / f"step_{step:08d}" / "manifest.json") as f:
        return step, json.load(f)


@pytest.mark.parametrize("mesh,need", [("pod", 256), ("multipod", 512)])
def test_launch_train_production_meshes_need_their_world(pool, mesh, need):
    """``--mesh pod`` / ``multipod`` on a world of 4 raises, naming the
    rank count the mesh needs (and the world's)."""
    argv = ["--arch", "h2o-danube-1.8b", "--smoke", "--steps", "1",
            "--mesh", mesh]
    errs = pool.run(td.train_cli_error, argv)
    assert all(f"needs {need} ranks; the world has 4" in e for e in errs)
