"""How far the port's and the reference's float32 train runs sit from a
float64 run of the same smoke config (ROADMAP C4: Zamba2's f32 gap).

Both packages keep float32 inside a float64 model (the SSD's operands,
the norms, the logits, AdamW's moments), so the float64 run is the port
with every float32 cast of ``models/`` and ``train/optim.py`` widened to
float64: a copy in a temporary directory, made by this script.  From the
``_torch_tp`` harness's weights and batches, each of the three runs
(reference f32, port f32, port f64) gives the step-1 gradients of
``BATCHES`` batches and the losses and weights of ``_torch_tp.KW``'s 3
steps of ``train()`` on one device.  Printed: per leaf the median over the
batches of each f32 gradient's distance from the f64 one (a fraction of
the leaf's max |g|), and each f32 run's losses and final weights against
the f64 run's.

With ``--mesh DxM`` the f32 runs are the split-step parity tests' own
(``_torch_tp``): the reference's ``train(mesh=)`` on 4 virtual devices,
once with XLA's CPU threads pinned (as the tests run it) and once at
XLA's defaults, and the port's split route on 4 gloo ranks; beside them
the one-device runs above and a float64 run from weights each moved by
one float32 rounding (2^-24 relative: how far the problem itself moves
under f32 noise in its inputs).  Printed: per leaf each run's step-1
gradient against float64; its final weights' max and root-mean-square
distance from float64 over the entries the tests hold (step-1 gradient
at least ``SIGN_FRAC`` of the leaf's max), and the port's from the
pinned reference (the tests' measure); at the entry where those two
differ most, each run's distance from float64; last, the port's split
route run in float64 against its one-process float64 run.

Usage (the CPU, ~2 min for Zamba2 smoke; ~3 min with ``--mesh``):
  PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_f32_spread.py \\
      --arch zamba2_7b
  PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_f32_spread.py \\
      --arch mamba2_130m --mesh 1x4
"""
import argparse
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

from _torch_parity import PINNED_XLA_FLAGS, reference_env

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCHES = 6

_RUN = """
import sys, pathlib, tempfile, numpy as np
sys.path.insert(0, %(tests)r)
import jax, jax.numpy as jnp, torch
import _torch_tp as tp
from repro import configs as jconfigs
from repro.train.data import make_source
name, out, which, dt, jitter = %(args)r
W = jax.tree.map(lambda a: np.asarray(a, dt), tp.weights(name, {}))
if jitter:
    # every weight moved by about one float32 rounding (2^-24 relative)
    rng = np.random.default_rng(jitter)
    W = jax.tree.map(
        lambda a: a * (1 + 2.0 ** -24 * rng.choice([-1.0, 1.0], a.shape)), W)
jcfg = jconfigs.get_smoke(name).with_(dtype="float32")
res = {}
def keep(prefix, tree):
    for g in tree:
        for k, v in tree[g].items():
            res[f"{prefix}/{g}/{k}"] = np.asarray(v)
def batch(step):
    return make_source(jcfg, tp.SEQ, tp.BATCH, 0)(step)
if which == "ref":
    from repro.models import lm
    from repro.train import loop, optim
    grad = jax.jit(jax.grad(lambda p, b: lm.loss_fn(jcfg, p, b)[0]))
    for s in range(%(n)d):
        keep(f"grad{s}", jax.tree.map(np.asarray, grad(
            jax.tree.map(jnp.asarray, W), batch(s))))
    opt = optim.AdamW(weight_decay=0.1, clip_norm=1.0)
    st = lm.TrainState(jax.tree.map(jnp.asarray, W), opt.init(W),
                       jnp.zeros((), jnp.int32))
    ck = pathlib.Path(tempfile.mkdtemp())
    r = loop.train(jcfg, loop.TrainerConfig(ckpt_dir=str(ck), ckpt_every=100,
                                            **tp.KW), state=st,
                   log=lambda *a: None)
    d = ck / f"step_{tp.STEPS:08d}"
    keep("w", {g: {k: np.load(d / f"params__{g}__{k}.npy") for k in W[g]}
               for g in W})
else:
    from repro_torch import configs, convert
    from repro_torch.models import lm
    from repro_torch.train import loop, optim
    cfg = configs.get_smoke(name).with_(dtype=dt, param_dtype=dt)
    for s in range(%(n)d):
        b = batch(s)
        model = convert.lm_params_from_numpy(cfg, W, device="cpu")
        model.requires_grad_(True)
        tb = lm.Batch(*(None if x is None else torch.as_tensor(np.asarray(x))
                        for x in b))
        _, g = optim.accumulate_gradients(
            lambda p, bb: lm.loss_fn(cfg, p, bb), model, tb, 1)
        keep(f"grad{s}", convert.lm_params_to_numpy(g))
    st = lm.init_train_state(convert.lm_params_from_numpy(cfg, W,
                                                          device="cpu"),
                             optim.AdamW(weight_decay=0.1, clip_norm=1.0))
    r = loop.train(cfg, loop.TrainerConfig(**tp.KW), state=st,
                   log=lambda *a: None, device="cpu")
    keep("w", convert.lm_params_to_numpy(r.state.params))
res["loss"] = np.asarray(r.losses)
np.savez(out, **res)
"""


_MESH64 = """
import sys, numpy as np
sys.path.insert(0, %(tests)r)
import jax
import _torch_tp as tp
import test_torch_ranks as td
arch, shape, out = %(args)r
W = jax.tree.map(lambda a: np.asarray(a, np.float64), tp.weights(arch, {}))
pool = td.RankPool(4)
try:
    r = pool.run(td.tp_run, arch, {"dtype": "float64",
                                   "param_dtype": "float64"}, shape, W,
                 tp.KW)[0]
finally:
    pool.close()
np.savez(out, loss=np.asarray(r["losses"]),
         **{f"w/{g}/{n}": v for g, ls in r["state"]["params"].items()
            for n, v in ls.items()})
"""


def f64_port(dest: pathlib.Path) -> pathlib.Path:
    """A copy of ``src/repro_torch`` whose models and optimizer compute in
    float64 where they cast to float32; returns the directory to put on
    ``sys.path``."""
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dest / "repro_torch")
    files = list((dest / "repro_torch" / "models").glob("*.py")) + [
        dest / "repro_torch" / "train" / "optim.py"]
    for f in files:
        text = re.sub(r"\.float\(\)", ".double()", f.read_text())
        f.write_text(text.replace("torch.float32", "torch.float64"))
    return dest


def run(which: str, name: str, dt: str, out: pathlib.Path, path: str,
        jitter: int = 0):
    script = _RUN % dict(tests=str(ROOT / "tests"), n=BATCHES,
                         args=(name, str(out), which, dt, jitter))
    return _script(script, out, path)


def _script(script: str, out: pathlib.Path, path: str):
    env = dict(reference_env(), JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([path, str(ROOT / "src")]))
    subprocess.run([sys.executable, "-c", script], env=env, check=True)
    return np.load(out)


def _unpinned_env(n_devices=None) -> dict:
    """``reference_env`` without PINNED_XLA_FLAGS: the reference at XLA's
    default CPU threads, only to measure what the pin changes."""
    env = reference_env(n_devices)
    env["XLA_FLAGS"] = env["XLA_FLAGS"].replace(PINNED_XLA_FLAGS, "").strip()
    return env


def split_f64(arch: str, shape: tuple, f64, out: pathlib.Path,
              wide: str) -> None:
    """The port's split route in float64 (the widened copy on 4 gloo
    ranks) against its one-process float64 run ``f64``: whether the split
    route computes the same function, apart from its rounding."""
    m64 = _script(_MESH64 % dict(tests=str(ROOT / "tests"),
                                 args=(arch, shape, str(out))), out, wide)
    dw = max(np.abs(m64[k] - f64[k]).max() for k in m64.files
             if k.startswith("w/"))
    print(f"split route in float64 on {'x'.join(map(str, shape))} - one "
          f"process in float64: losses {(m64['loss'] - f64['loss']).tolist()}"
          f", final weights max |dw| {dw:.3e}")


def mesh_spread(arch: str, shape: tuple, f64, one: dict,
                tmp: pathlib.Path) -> None:
    """The split-step tests' f32 runs of ``arch`` on the mesh ``shape``
    (the reference pinned and at XLA's defaults, the port on 4 gloo
    ranks) and the one-device runs ``one`` (name -> ``run``'s arrays)
    against the port's float64 run ``f64``: the step-1 gradients and the
    final weights over the entries the tests hold."""
    import _torch_tp as tp
    import test_torch_ranks as td
    case = [(arch, arch, {})]
    k = tp.key(shape)
    refs = {}
    for tag, env in (("pin", reference_env), ("dflt", _unpinned_env)):
        (tmp / tag).mkdir()
        tp.reference_env = env
        refs[tag] = tp.run_reference(case, tmp / tag)
    tp.reference_env = reference_env
    pool = td.RankPool(4)
    try:
        port = pool.run(td.tp_run, arch, {}, shape, tp.weights(arch, {}),
                        tp.KW)[0]
    finally:
        pool.close()
    leaves = sorted(port["grads"])
    weights = {"port": {f"{g}/{n}": v for g, ls in
                        port["state"]["params"].items()
                        for n, v in ls.items()}}
    grads = {"port": port["grads"]}
    losses = {"port": np.asarray(port["losses"])}
    for tag, ref in refs.items():
        d = ref["ckpt"] / arch / k / f"step_{tp.STEPS:08d}"
        weights[f"ref {tag}"] = {
            leaf: np.load(d / f"params__{leaf.replace('/', '__')}.npy")
            for leaf in leaves}
        grads[f"ref {tag}"] = {leaf: ref["out"][f"{arch}/{k}/grad/{leaf}"]
                               for leaf in leaves}
        losses[f"ref {tag}"] = ref["out"][f"{arch}/{k}/losses"]
    for name, a in one.items():
        weights[name] = {leaf: a[f"w/{leaf}"] for leaf in leaves}
        grads[name] = {leaf: a[f"grad0/{leaf}"] for leaf in leaves}
        losses[name] = a["loss"]
    names = list(weights)
    head = "  ".join(f"{n:>10}" for n in names)
    print(f"{arch} on {k} ({', '.join(names[:3])}; one device: "
          f"{', '.join(names[3:])})")
    print(f"step-1 gradients, max |g - g64| / max |g64| per leaf:")
    print(f"  {'leaf':<22} {head}")
    for leaf in leaves:
        t64 = f64[f"grad0/{leaf}"]
        mx = np.abs(t64).max() or 1.0
        print(f"  {leaf:<22} " + "  ".join(
            f"{np.abs(grads[n][leaf] - t64).max() / mx:10.3e}"
            for n in names))
    worst, rms = (-1.0, None), []
    print(f"final weights after {tp.STEPS} steps, max |w - w64| over the "
          f"held entries (and port - ref pin, the tests' measure):")
    print(f"  {'leaf':<22} {'held':>7} {head} {'port-pin':>10}")
    for leaf in leaves:
        grad = np.abs(grads["ref pin"][leaf])
        keep = (grad >= tp.SIGN_FRAC * grad.max()) | (grad == 0)
        w = {n: weights[n][leaf][keep].astype(np.float64) for n in names}
        t64 = f64[f"w/{leaf}"][keep]
        gap = np.abs(w["port"] - w["ref pin"])
        print(f"  {leaf:<22} {int(keep.sum()):7d} " + "  ".join(
            f"{np.abs(w[n] - t64).max():10.3e}" for n in names)
            + f" {gap.max():10.3e}")
        rms.append(f"  {leaf:<22} {int(keep.sum()):7d} " + "  ".join(
            f"{np.sqrt(np.mean((w[n] - t64) ** 2)):10.3e}" for n in names)
            + f" {np.sqrt(np.mean(gap ** 2)):10.3e}")
        if gap.max() > worst[0]:
            i = int(gap.argmax())
            worst = (gap.max(), (leaf, i, {n: w[n][i] - t64[i]
                                           for n in names}, t64[i]))
    print("the same, root mean square over the held entries:")
    print("\n".join(rms))
    leaf, i, dev, t64 = worst[1]
    print(f"widest port - ref pin entry: {leaf}[held {i}] = {t64:.9f} "
          f"(float64); " + ", ".join(f"{n} - f64 {d:+.3e}"
                                     for n, d in dev.items()))
    for n, v in losses.items():
        print(f"{n} - float64: losses {(v - f64['loss']).tolist()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2_7b")
    ap.add_argument("--mesh", default=None,
                    help="DxM: the split-step tests' f32 runs on this mesh")
    args = ap.parse_args(argv)
    src = str(ROOT / "src")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        wide = f64_port(tmp / "f64_port")
        f64 = run("port", args.arch, "float64", tmp / "f64.npz", str(wide))
        ref = run("ref", args.arch, "float32", tmp / "ref.npz", src)
        port = run("port", args.arch, "float32", tmp / "port.npz", src)
        if args.mesh:
            shape = tuple(int(x) for x in args.mesh.split("x"))
            ulp = run("port", args.arch, "float64", tmp / "ulp.npz",
                      str(wide), jitter=1)
            mesh_spread(args.arch, shape, f64, {"port 1": port, "ref 1": ref,
                                                "f64 ulp": ulp}, tmp)
            split_f64(args.arch, shape, f64, tmp / "m64.npz", str(wide))
            return 0
        leaves = sorted({k.split("/", 1)[1] for k in f64.files
                         if k.startswith("grad")})
        print(f"{args.arch}: step-1 gradients against float64, median over "
              f"{BATCHES} batches, of each leaf's max |g|")
        print(f"  {'leaf':<22} {'port f32':>10} {'ref f32':>10} {'ratio':>6}")
        for leaf in leaves:
            errs = [[], []]
            for s in range(BATCHES):
                t = f64[f"grad{s}/{leaf}"]
                mx = np.abs(t).max()
                if mx == 0:
                    continue
                for i, a in enumerate((port, ref)):
                    errs[i].append(np.abs(a[f"grad{s}/{leaf}"] - t).max() / mx)
            p, r = np.median(errs[0]), np.median(errs[1])
            print(f"  {leaf:<22} {p:10.3e} {r:10.3e} {p / r:6.2f}")
        wl = [k for k in f64.files if k.startswith("w/")]
        print(f"losses, float64: {f64['loss'].tolist()}")
        for tag, a in (("port f32", port), ("ref f32", ref)):
            dw = max(np.abs(a[k] - f64[k]).max() for k in wl)
            print(f"{tag} - float64: losses {(a['loss'] - f64['loss']).tolist()}"
                  f", final weights max |dw| {dw:.3e}")
        dw = max(np.abs(port[k] - ref[k]).max() for k in wl)
        print(f"port f32 - ref f32: losses "
              f"{(port['loss'] - ref['loss']).tolist()}, final weights max "
              f"|dw| {dw:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
