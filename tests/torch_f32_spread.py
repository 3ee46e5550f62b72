"""How far the port's and the reference's float32 train runs sit from a
float64 run of the same smoke config (ROADMAP C4: Zamba2's f32 gap).

Both packages keep float32 inside a float64 model (the SSD's operands,
the norms, the logits, AdamW's moments), so the float64 run is the port
with every float32 cast of ``models/`` and ``train/optim.py`` widened to
float64: a copy under ``build/f64_port``, made by this script.  From the
``_torch_tp`` harness's weights and batches, each of the three runs
(reference f32, port f32, port f64) gives the step-1 gradients of
``BATCHES`` batches and the losses and weights of ``_torch_tp.KW``'s 3
steps of ``train()`` on one device.  Printed: per leaf the median over the
batches of each f32 gradient's distance from the f64 one (a fraction of
the leaf's max |g|), and each f32 run's losses and final weights against
the f64 run's.

Usage (the CPU, ~2 min for Zamba2 smoke):
  PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_f32_spread.py \\
      --arch zamba2_7b
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

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCHES = 6

_RUN = """
import sys, pathlib, tempfile, numpy as np
sys.path.insert(0, %(tests)r)
import jax, jax.numpy as jnp, torch
import _torch_tp as tp
from repro import configs as jconfigs
from repro.train.data import make_source
name, out, which, dt = %(args)r
W = jax.tree.map(lambda a: np.asarray(a, dt), tp.weights(name, {}))
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


def run(which: str, name: str, dt: str, out: pathlib.Path, path: str):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([path, str(ROOT / "src")]))
    script = _RUN % dict(tests=str(ROOT / "tests"), n=BATCHES,
                         args=(name, str(out), which, dt))
    subprocess.run([sys.executable, "-c", script], env=env, check=True)
    return np.load(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2_7b")
    args = ap.parse_args(argv)
    src = str(ROOT / "src")
    wide = f64_port(ROOT / "build" / "f64_port")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        ref = run("ref", args.arch, "float32", tmp / "ref.npz", src)
        port = run("port", args.arch, "float32", tmp / "port.npz", src)
        f64 = run("port", args.arch, "float64", tmp / "f64.npz", str(wide))
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
