"""Shared harness of ``test_torch_tp.py``, ``test_torch_tp_moe.py`` and
``test_torch_tp_ssm.py``: the split route of the sharded train step
(``repro_torch.models.parallel``) on 4 gloo ranks against the reference's
``train(mesh=)`` on 4 virtual XLA devices, in float32.

A case is ``(key, smoke config name, overrides)``; both packages start
from the reference's weights (``convert.lm_params_from_numpy``) and draw
the same batches.  The reference runs once per file in a subprocess (it
needs ``XLA_FLAGS`` set before JAX starts): each case's losses on each
mesh, its step-1 gradient, its parameters' shard shapes and its step-3
checkpoint.
"""
import math
import subprocess
import sys
from fractions import Fraction

import jax
import numpy as np

from repro import configs as jconfigs
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import layers, lm
from repro_torch.models.config import spec_axes

import test_torch_dryrun as td_dry
import test_torch_ranks as td
from _torch_parity import reference_env
from test_torch_lm_train import GRAD_ATOL, GRAD_RTOL

MESHES = ((1, 4), (2, 2))
SEQ, BATCH, STEPS = 64, 4, 3
KW = dict(seq_len=SEQ, global_batch=BATCH, steps=STEPS, peak_lr=1e-3,
          warmup=0, log_every=0)
#: test_torch_train_mp's bounds: every step's loss (float32 in two
#: libraries over other reduction orders), and the final parameters
#: where the reference's step-1 gradient is at least SIGN_FRAC of its
#: leaf's max or exactly zero, the rest counted under LEFT_OUT
LOSS_TOL = 1e-5
SIGN_FRAC, PARAM_TOL, LEFT_OUT = 1e-3, 5e-6, 0.05
#: the model team's all-gathers against one whole-model gather on the
#: same mesh: only the leaves a split piece reads whole (kv projections
#: that do not split, the router) cross "model"
MODEL_GATHER_SHARE = 0.1
#: the leaves a split Mamba2 block gathers whole over "model": their
#: "heads" dimension is the concatenation z | x | B | C | dt (or x | B |
#: C), whose "model" blocks do not line up with a rank's heads
SSM_MODEL_GATHERED = ("ssm_in", "ssm_conv", "ssm_conv_b")


def key(shape) -> str:
    return "x".join(map(str, shape))


def bounds(table: dict, case: str, shape) -> dict:
    """A case's entry of a file's ``BOUNDS``: under ``(case, mesh key)``
    for that mesh alone, else under ``case``, else none."""
    return table.get((case, key(shape)), table.get(case, {}))


def ids(v) -> str:
    """Test ids of (case, mesh) parameters: the case's key, the mesh's."""
    return key(v) if isinstance(v, tuple) and isinstance(v[0], int) \
        else v[0]


def weights(name, over):
    """The reference's init at seed 0, zero leaves moved off zero."""
    cfg = jconfigs.get_smoke(name).with_(dtype="float32", **over)
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
from repro.models import lm
from repro.train import loop, optim
from repro.train.data import make_source
warnings.simplefilter("ignore")
inp, out_path, root = np.load(sys.argv[1]), sys.argv[2], sys.argv[3]
kw = %(kw)r
out = {}
def nest(case):
    tree = {}
    for k in inp.files:
        if k.startswith(case + "/"):
            node = tree
            *path, leaf = k.split("/")[1:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = inp[k]
    return tree
for case, name, over in %(cases)r:
    cfg = configs.get_smoke(name).with_(dtype="float32", **over)
    params = nest(case)
    batch = make_source(cfg, kw["seq_len"], kw["global_batch"], 0)(0)
    for shape in %(meshes)r:
        key = "x".join(map(str, shape))
        mesh = make_mesh(shape, ("data", "model"))
        opt = optim.AdamW(weight_decay=0.1, clip_norm=1.0)
        state = lm.TrainState(jax.tree.map(jnp.asarray, params),
                              opt.init(params), jnp.zeros((), jnp.int32))
        tc = loop.TrainerConfig(ckpt_dir=f"{root}/{case}/{key}",
                                ckpt_every=100, **kw)
        res = loop.train(cfg, tc, mesh=mesh, state=state,
                         log=lambda *a: None)
        out[f"{case}/{key}/losses"] = np.asarray(res.losses)
        grad = jax.jit(jax.grad(lambda p: lm.loss_fn(cfg, p, batch)[0]))
        with use_mesh(mesh):
            g = jax.tree.map(np.asarray, grad(params))
        for group, leaves in g.items():
            for k, v in leaves.items():
                out[f"{case}/{key}/grad/{group}/{k}"] = v
        shard = lm.param_shardings(cfg, mesh, max_len=kw["seq_len"])
        for group, leaves in shard.items():
            for k, s in leaves.items():
                shp = s.shard_shape(params[group][k].shape)
                out[f"{case}/{key}/shard/{group}/{k}"] = np.asarray(shp)
np.savez(out_path, **out)
print("OK")
"""


_SCHEDULE = """
import re, sys, warnings
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.comm.compat import use_mesh
from repro.launch.mesh import make_mesh
from repro.launch.roofline import parse_collectives
from repro.models import lm, transformer as T
from repro.train.optim import AdamW, cosine_schedule
warnings.simplefilter("ignore")
name, over, shapes, (b, length) = %(args)r
cfg = configs.get_smoke(name).with_(dtype="float32", **over)
opt = AdamW()
for shape in shapes:
    mesh = make_mesh(shape, ("data", "model"))
    with use_mesh(mesh):
        ps = lm.param_shardings(cfg, mesh, max_len=length)
        shapes_p = jax.eval_shape(
            lambda: T.init_params(cfg, jax.random.PRNGKey(0), max_len=length))
        st_sh = lm.TrainState(ps, lm.opt_shardings(cfg, mesh, opt,
                                                   max_len=length),
                              NamedSharding(mesh, P()))
        st = lm.TrainState(shapes_p, jax.eval_shape(opt.init, shapes_p),
                           jax.ShapeDtypeStruct((), jnp.int32))
        tok = jax.ShapeDtypeStruct((b, length), jnp.int32)
        step = lm.make_train_step(cfg, opt, cosine_schedule(3e-4, 10, 100))
        hlo = jax.jit(step, in_shardings=(st_sh, lm.batch_shardings(cfg, mesh)),
                      donate_argnums=(0,)).lower(
            st, lm.Batch(tok, tok)).compile().as_text()
    comps, cur = {}, None
    for line in hlo.splitlines():
        m = re.match(r"^(?:ENTRY )?%%?([\\w.\\-]+) .*\\{$", line)
        if m:
            cur = comps.setdefault(m.group(1), [])
        elif cur is not None:
            cur.append(line)
    loops = {}            # body -> trip count, of every while loop
    for lines in comps.values():
        for ln in lines:
            m = re.search(r" while\\(.*body=%%?([\\w.\\-]+)", ln)
            if m:
                n = re.search(r'known_trip_count":\\{"n":"(\\d+)"', ln)
                loops[m.group(1)] = int(n.group(1)) if n else -1
    def closure(c, seen):
        if c not in seen:
            seen.add(c)
            for ln in comps.get(c, []):
                for m in re.finditer(r"(?:body|condition|calls|to_apply)="
                                     r"%%?([\\w.\\-]+)", ln):
                    closure(m.group(1), seen)
        return seen
    for body, trips in loops.items():
        inner = closure(body, set()) - {body}
        nested = [b for b in loops if b in inner]
        own = closure(body, set()) - set().union(
            *(closure(b, set()) for b in nested))
        text = "\\n".join(ln for c in own for ln in comps[c])
        n_ag = parse_collectives(text).counts.get("all-gather", 0)
        print("LOOP", "x".join(map(str, shape)), trips, len(nested), n_ag)
"""


def reference_loop_gathers(name, over, shapes, batch, length):
    """The all-gathers of the reference's compiled train step (jit of
    ``make_train_step`` under ``param_shardings``, 4 virtual devices) by
    while loop: ``{mesh key: [(trip count, loops nested in it, all-gathers
    in its own body)]}``."""
    env = reference_env(4)
    script = _SCHEDULE % dict(args=(name, over, list(shapes),
                                    (batch, length)))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out: dict = {}
    for line in proc.stdout.splitlines():
        if line.startswith("LOOP "):
            k, trips, nested, n_ag = line.split()[1:]
            out.setdefault(k, []).append((int(trips), int(nested),
                                          int(n_ag)))
    return out


def run_reference(cases, tmp):
    """The reference's runs of ``cases`` on every mesh of ``MESHES`` in
    one 4-device subprocess: ``{"out": arrays, "ckpt": checkpoint root}``."""
    flat = {}
    for case, name, over in cases:
        flat.update(_flat(weights(name, over), f"{case}/"))
    np.savez(tmp / "in.npz", **flat)
    env = reference_env(4)
    script = _REFERENCE % dict(kw=KW, cases=list(cases),
                               meshes=list(MESHES))
    proc = subprocess.run(
        [sys.executable, "-c", script, str(tmp / "in.npz"),
         str(tmp / "out.npz"), str(tmp / "ckpt")], env=env,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = np.load(tmp / "out.npz")
    return {"out": {k: out[k] for k in out.files}, "ckpt": tmp / "ckpt"}


def run_port(pool, cases):
    """``test_torch_ranks.tp_run`` of every case on every mesh."""
    return {(case, shape): pool.run(td.tp_run, name, over, shape,
                                    weights(name, over), KW)
            for case, name, over in cases for shape in MESHES}


def _leaf_names(name, over):
    """(group, leaf) of each parameter in ``optim.tree_leaves``' order."""
    tcfg = tconfigs.get_smoke(name).with_(dtype="float32", **over)
    model = convert.lm_params_from_numpy(tcfg, weights(name, over),
                                         device="cpu")
    return [(g, k) for g, leaves in sorted(model.tree().items())
            for layer in (leaves if isinstance(leaves, list) else [leaves])
            for k in sorted(layer)]


def _ref_shard(ref, case, shape, group, k) -> tuple:
    shp = tuple(ref[f"{case}/{key(shape)}/shard/{group}/{k}"])
    return shp[1:] if group in ("blocks", "enc") else shp


def check_losses_and_params(reference, res, case, shape, tols=None,
                            param_tol=PARAM_TOL, left_out_frac=LEFT_OUT):
    """Every rank's losses within LOSS_TOL (or ``tols``, one per step) of
    the reference's on the same mesh (and equal across ranks); the final
    parameters gathered whole against the reference's step-3 checkpoint,
    within ``param_tol``, where its step-1 gradient is at least SIGN_FRAC
    of the leaf's max (or zero), the rest under ``left_out_frac``."""
    ref = reference["out"]
    want = ref[f"{case}/{key(shape)}/losses"]
    tol = np.full(STEPS, LOSS_TOL) if tols is None else np.asarray(tols)
    for r in res:
        assert (np.abs(np.asarray(r["losses"]) - want) <= tol).all(), (
            r["losses"], want, tol)
    assert len({tuple(r["losses"]) for r in res}) == 1
    step_dir = reference["ckpt"] / case / key(shape) / f"step_{STEPS:08d}"
    left_out = total = 0
    for group, leaves in res[0]["state"]["params"].items():
        for k, got in leaves.items():
            w = np.load(step_dir / f"params__{group}__{k}.npy")
            g = np.abs(ref[f"{case}/{key(shape)}/grad/{group}/{k}"])
            keep = (g >= SIGN_FRAC * g.max()) | (g == 0)
            left_out += int((~keep).sum())
            total += keep.size
            np.testing.assert_allclose(got[keep], w[keep], rtol=0,
                                       atol=param_tol, err_msg=f"{group}/{k}")
    assert left_out < left_out_frac * total, (left_out, total)


def check_step1_grads(reference, res, case, shape):
    """Rank 0's step-1 gradients, gathered whole, against the reference's
    ``jax.grad`` of the same batch: each leaf within
    ``test_torch_lm_train``'s bound of its max |g| (float32 in two
    libraries)."""
    ref = reference["out"]
    prefix = f"{case}/{key(shape)}/grad/"
    want = {k[len(prefix):]: ref[k] for k in ref if k.startswith(prefix)}
    got = res[0]["grads"]
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        tol = GRAD_RTOL * np.abs(w).max() + GRAD_ATOL
        err = np.abs(got[k] - w).max()
        assert err <= tol, (k, err, tol)


def check_block_shapes(reference, res, case, name, over, shape):
    """Each rank's parameter blocks, after training, and its gradient
    blocks of one step shaped as the reference's shards."""
    ref = reference["out"]
    names = _leaf_names(name, over)
    for r in res:
        assert len(r["shapes"]) == len(names)
        for (group, k), got in zip(names, r["shapes"]):
            assert got == _ref_shard(ref, case, shape, group, k), (group, k)
        for path, got in r["grad_shapes"].items():
            group, _, k = path.split("/")
            assert got == _ref_shard(ref, case, shape, group, k), path


def check_norm_grads_equal(res):
    """The norm leaves' gradients bit-equal on every rank of a model team
    (the ranks of one data coordinate)."""
    by_data: dict = {}
    for r in res:
        by_data.setdefault(r["coords"]["data"], []).append(r)
    assert res[0]["norm_grads"]
    for team in by_data.values():
        for r in team[1:]:
            assert r["norm_grads"].keys() == team[0]["norm_grads"].keys()
            for k, g in r["norm_grads"].items():
                np.testing.assert_array_equal(g, team[0]["norm_grads"][k],
                                              err_msg=k)


def _specs_and_wholes(name, over, shape):
    """(group, leaf, spec, whole shape) of every parameter of the smoke
    config ``name`` on a (data, model) mesh of ``shape``, per layer."""
    cfg = tconfigs.get_smoke(name).with_(dtype="float32", **over)
    mesh = td_dry._MeshStub(shape, ("data", "model"))
    tree = lm.param_shardings(cfg, mesh, SEQ)
    named = [(g, k, s) for g in sorted(tree)
             for layer in (tree[g] if isinstance(tree[g], list)
                           else [tree[g]])
             for k, s in sorted(layer.items())]
    wholes = td_dry._whole_shapes(cfg, SEQ)
    assert len(named) == len(wholes)
    return [n + (w,) for n, w in zip(named, wholes)]


def _gathers(spec, whole, sizes, over_model: bool):
    """The all-gather wire bytes (float32) of one leaf's block gathered
    per sharded dimension (the FSDP axes first, as ``Split._plan``
    orders them), over "model" as well when ``over_model``: (over the
    other axes, over "model")."""
    ext = [math.prod(sizes[a] for a in spec_axes(e)) for e in spec]
    block = [d // e for d, e in zip(whole, ext)]
    got = [Fraction(0), Fraction(0)]
    for dim, e in sorted(enumerate(spec),
                         key=lambda de: "model" in spec_axes(de[1])):
        model = "model" in spec_axes(e)
        if ext[dim] == 1 or (model and not over_model):
            continue
        got[model] += (ext[dim] - 1) * 4 * math.prod(block)
        block[dim] *= ext[dim]
    return tuple(got)


def whole_gather_bytes(name, over, shape) -> Fraction:
    """The all-gather wire bytes (float32) of one whole-model gather of the
    smoke config ``name`` on a (data, model) mesh of ``shape``, from
    ``param_shardings``: per leaf one all-gather per sharded dimension of
    the block gathered so far."""
    sizes = dict(zip(("data", "model"), shape))
    return sum((sum(_gathers(spec, whole, sizes, True))
                for _, _, spec, whole in _specs_and_wholes(name, over,
                                                           shape)),
               Fraction(0))


def ssm_model_gather_bytes(name, over, shape) -> Fraction:
    """The all-gather wire bytes (float32) over "model" of one step of the
    split route where the SSM heads split and every other piece reads its
    own "model" block: per layer each SSM_MODEL_GATHERED leaf's block,
    gathered over "data" first, then over "model"."""
    sizes = dict(zip(("data", "model"), shape))
    return sum((_gathers(spec, whole, sizes, True)[1]
                for _, k, spec, whole in _specs_and_wholes(name, over,
                                                           shape)
                if k in SSM_MODEL_GATHERED), Fraction(0))


def moe_gather_bytes(name, over, shape) -> Fraction:
    """The all-gather wire bytes (float32) over "model" of one step's MoE
    activations on the split route, where the experts split by experts
    ("ep", "ep_virtual"): per layer the rank's block of the experts'
    outputs gathered whole (forward) and of the dispatch buffer's gradient
    (backward), (E / m, c, d) each, c the capacity of a data shard's
    dispatch; 0 for a model without experts or under "tp"."""
    cfg = tconfigs.get_smoke(name).with_(dtype="float32", **over)
    n_data, m = shape
    if not cfg.n_experts or cfg.expert_sharding == "tp" or m == 1:
        return Fraction(0)
    assert not cfg.remat and cfg.n_micro == 1, name
    c = layers.moe_capacity(cfg, BATCH * SEQ) // n_data
    block = cfg.n_experts_disp // m * c * cfg.d_model * 4
    return Fraction(cfg.n_layers * 2 * (m - 1) * block)


def _model_gathers(r) -> Fraction:
    return sum((Fraction(b) for prim, axes, b in r["events"]
                if prim == "all_gather" and "model" in axes), Fraction(0))


def check_census(res, name, over, shape, share=MODEL_GATHER_SHARE):
    """One step's collectives on every rank: all-gathers over the FSDP
    axis (per layer) and, over the model team, the MoE's activations
    (:func:`moe_gather_bytes`) and at most ``share`` of the whole-model
    gather's bytes besides (only the leaves a piece reads whole cross
    "model"); the activations' all-reduces over the model team where it
    splits."""
    whole = whole_gather_bytes(name, over, shape)
    act = moe_gather_bytes(name, over, shape)
    for r in res:
        got = _model_gathers(r)
        assert act <= got <= act + share * whole, (got, act, whole)
        _check_rest(r, shape, whole, act)


def check_ssm_census(res, name, over, shape):
    """:func:`check_census` with the model team's all-gathers equal,
    exactly, to :func:`ssm_model_gather_bytes`."""
    want = ssm_model_gather_bytes(name, over, shape)
    whole = whole_gather_bytes(name, over, shape)
    for r in res:
        assert _model_gathers(r) == want, (_model_gathers(r), want)
        _check_rest(r, shape, whole)


def _check_rest(r, shape, whole, act=0):
    gathers = [(axes, Fraction(b)) for prim, axes, b in r["events"]
               if prim == "all_gather"]
    assert sum(b for _, b in gathers) - act < whole
    if shape[0] > 1:
        assert any(axes == ("data",) for axes, _ in gathers)
    reduces = {e[1] for e in r["events"] if e[0] == "psum"}
    if shape[1] > 1:
        assert ("model",) in reduces
