"""Shared harness of ``test_torch_tp_serve.py`` and
``test_torch_tp_serve_ssm.py``: prefill and decode on a mesh of 4 gloo
ranks (``lm.make_prefill`` / ``make_decode_step`` with ``mesh=``) against
the reference's program on 4 virtual XLA devices, jitted with the
shardings of ``repro.launch.dryrun._lower`` (parameters under
``param_shardings``, the cache under ``cache_shardings``, tokens under
``("batch", "seq")``, frames under ``("batch", "seq", "embed")``, the
logits out under ``("batch", "vocab")``, the next token under
``("batch",)``), in float32.

A case is ``(key, smoke config name, overrides, max_len, prompt
length)``; each runs on the meshes (data, model) = (1, 4) and (2, 2) at
global batches of 4 and 1: the prompt, then ``STEPS`` decode steps
teacher-forced with the reference's greedy tokens.  Both packages start
from the reference's weights (``_torch_tp.weights``) and the same numpy
tokens (and Whisper's frames).  The reference runs once per file in a
subprocess; the port once per (case, mesh, batch) on a ``RankPool``.
"""
import subprocess
import sys

import numpy as np

import _torch_tp as tp
import test_torch_ranks as td
from _torch_parity import reference_env

MESHES = tp.MESHES
BATCHES = (4, 1)
STEPS = 4
#: prefill's last logits and every cache leaf after prefill and after
#: each decode step, as ``assert_allclose(rtol=TOL, atol=TOL)``: the
#: zoo's serving bound (test_torch_lm_serve's float32 TOL, held the same
#: way).  Zamba2's SSM state h reaches |h| ~ 9 after four decode steps;
#: there the port in one process already sits 7.9e-5 from the reference
#: (the one-process gap, ROADMAP C4), inside 5e-5 + 5e-5 |h|
TOL = 5e-5


def tokens(cfg_vocab: int, batch: int, length: int, seed: int = 5):
    return np.random.default_rng(seed).integers(
        0, cfg_vocab, (batch, length)).astype(np.int32)


def frames(enc_len: int, d: int, batch: int, seed: int = 6):
    return np.random.default_rng(seed).standard_normal(
        (batch, enc_len, d)).astype(np.float32)


_REFERENCE = """
import sys, warnings
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.comm.compat import use_mesh
from repro.launch.mesh import make_mesh
from repro.models import lm, transformer as T
from repro.models.config import logical_to_spec
warnings.simplefilter("ignore")
inp, out_path = np.load(sys.argv[1]), sys.argv[2]
seq, steps = %(seq)r, %(steps)r
out = {}
def nest(case):
    tree = {}
    for k in inp.files:
        if k.startswith(case + "/w/"):
            node = tree
            *path, leaf = k.split("/")[2:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = inp[k]
    return tree
def leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], prefix + k + "/")
        else:
            yield prefix + k, tree[k]
def record(tag, arr, mesh):
    out[tag] = np.asarray(arr)
    pos = {d.id: ix for ix, d in np.ndenumerate(mesh.devices)}
    for s in arr.addressable_shards:
        coords = "x".join(map(str, pos[s.device.id]))
        out[tag + "@" + coords] = np.asarray(s.data.shape)
for case, name, over, max_len, length in %(cases)r:
    cfg = configs.get_smoke(name).with_(dtype="float32", **over)
    params = nest(case)
    for shape in %(meshes)r:
        mesh = make_mesh(shape, ("data", "model"))
        rules = cfg.rules()
        def sh(lg, dims):
            return NamedSharding(mesh, logical_to_spec(lg, dims, mesh, rules))
        for b in %(batches)r:
            tag = "%%s/%%s/%%d" %% (case, "x".join(map(str, shape)), b)
            toks = inp["%%s/tokens/%%d" %% (case, b)]
            with use_mesh(mesh):
                ps = lm.param_shardings(cfg, mesh, max_len=seq)
                cs = lm.cache_shardings(cfg, mesh, b, max_len)
                tok_sh = sh(("batch", "seq"), toks.shape)
                args = [jax.device_put(params, ps),
                        jax.device_put(T.init_cache(cfg, b, max_len), cs),
                        jax.device_put(toks, tok_sh)]
                in_sh = [ps, cs, tok_sh]
                if cfg.enc_dec:
                    fr = inp["%%s/frames/%%d" %% (case, b)]
                    fr_sh = sh(("batch", "seq", "embed"), fr.shape)
                    args.append(jax.device_put(fr, fr_sh))
                    in_sh.append(fr_sh)
                logits_sh = sh(("batch", "vocab"), (b, cfg.vocab_pad))
                prefill = jax.jit(lm.make_prefill(cfg, max_len),
                                  in_shardings=tuple(in_sh),
                                  out_shardings=(cs, logits_sh),
                                  donate_argnums=(1,))
                cache, logits = prefill(*args)
                record(tag + "/logits", logits, mesh)
                for k, v in leaves(cache):
                    record("%%s/cache0/%%s" %% (tag, k), v, mesh)
                nxt_sh = sh(("batch",), (b,))
                scalar = NamedSharding(mesh, P())
                decode = jax.jit(lm.make_decode_step(cfg),
                                 in_shardings=(ps, cs, nxt_sh, scalar),
                                 out_shardings=(cs, nxt_sh),
                                 donate_argnums=(1,))
                tok = jax.device_put(
                    jnp.argmax(logits, axis=-1).astype(jnp.int32), nxt_sh)
                out[tag + "/tok0"] = np.asarray(tok)
                for i in range(steps):
                    cache, tok = decode(args[0], cache, tok,
                                        jnp.asarray(length + i, jnp.int32))
                    record("%%s/tok%%d" %% (tag, i + 1), tok, mesh)
                    for k, v in leaves(cache):
                        record("%%s/cache%%d/%%s" %% (tag, i + 1, k), v, mesh)
np.savez(out_path, **out)
print("OK")
"""


def _inputs(cases):
    """The npz inputs of the reference: each case's weights, tokens and
    (Whisper) frames at every batch."""
    from repro import configs as jconfigs
    flat = {}
    for case, name, over, _, length in cases:
        flat.update(tp._flat(tp.weights(name, over), f"{case}/w/"))
        cfg = jconfigs.get_smoke(name)
        for b in BATCHES:
            flat[f"{case}/tokens/{b}"] = tokens(cfg.vocab, b, length)
            if cfg.enc_dec:
                flat[f"{case}/frames/{b}"] = frames(cfg.enc_len,
                                                    cfg.d_model, b)
    return flat


def run_reference(cases, tmp):
    """The reference's prefill and decode steps of every case on every
    mesh and batch in one 4-device subprocess: ``{tag: array}``, tags
    ``case/mesh/batch/{logits, tokN, cacheN/leaf}`` (and each device's
    block shape under ``tag@i x j``, its mesh coordinates)."""
    np.savez(tmp / "in.npz", **_inputs(cases))
    env = reference_env(4)
    script = _REFERENCE % dict(seq=tp.SEQ, steps=STEPS, cases=list(cases),
                               meshes=list(MESHES), batches=list(BATCHES))
    proc = subprocess.run(
        [sys.executable, "-c", script, str(tmp / "in.npz"),
         str(tmp / "out.npz")], env=env, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = np.load(tmp / "out.npz")
    return {k: out[k] for k in out.files}


def run_port(pool, cases, reference):
    """``test_torch_ranks.tp_serve`` of every case on every mesh and
    batch, teacher-forced with the reference's greedy tokens:
    ``{(case, shape, batch): per-rank results}``."""
    from repro import configs as jconfigs
    out = {}
    for case, name, over, max_len, length in cases:
        cfg = jconfigs.get_smoke(name)
        w = tp.weights(name, over)
        for shape in MESHES:
            for b in BATCHES:
                tag = f"{case}/{tp.key(shape)}/{b}"
                forced = [reference[f"{tag}/tok{i}"] for i in range(STEPS)]
                fr = (frames(cfg.enc_len, cfg.d_model, b) if cfg.enc_dec
                      else None)
                out[case, shape, b] = pool.run(
                    td.tp_serve, name, over, shape, w, tp.SEQ, max_len,
                    tokens(cfg.vocab, b, length), fr, forced, True)
    return out


def cases_mesh_batch(cases):
    return [(c, s, b) for c in cases for s in MESHES for b in BATCHES]


def ids(v):
    if isinstance(v, tuple) and isinstance(v[0], str):
        return v[0]
    if isinstance(v, tuple):
        return tp.key(v)
    return f"B{v}"


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if what.endswith("/pos"):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=what)


def check_logits(reference, res, case, shape, b):
    """Prefill's last logits, gathered whole, within TOL of the
    reference's on every rank."""
    want = reference[f"{case}/{tp.key(shape)}/{b}/logits"]
    for r in res:
        _close(r["logits"], want, f"{case} logits rank {r['rank']}")


def check_caches(reference, res, case, shape, b):
    """Every cache leaf, gathered whole, after prefill and after each
    decode step within TOL (``pos`` exact) of the reference's."""
    tag = f"{case}/{tp.key(shape)}/{b}"
    assert len(res[0]["caches"]) == STEPS + 1
    for i, cache in enumerate(res[0]["caches"]):
        prefix = f"{tag}/cache{i}/"
        want = {k[len(prefix):] for k in reference
                if k.startswith(prefix) and "@" not in k}
        assert set(cache) == want, (set(cache), want)
        for k, got in cache.items():
            _close(got, reference[prefix + k], prefix + k)


def check_tokens(reference, res, case, shape, b):
    """Each decode step's greedy tokens, gathered over the batch team,
    equal the reference's on every rank."""
    tag = f"{case}/{tp.key(shape)}/{b}"
    for r in res:
        for i, got in enumerate(r["tokens"]):
            np.testing.assert_array_equal(
                got, reference[f"{tag}/tok{i + 1}"],
                err_msg=f"{case} step {i + 1} rank {r['rank']}")


def check_block_shapes(reference, res, case, shape, b):
    """Each rank's blocks of the logits, the next token and every cache
    leaf after every call are the reference's shards on the device at the
    rank's mesh coordinates."""
    tag = f"{case}/{tp.key(shape)}/{b}"
    for r in res:
        at = f"@{r['coords']['data']}x{r['coords']['model']}"
        blocks = r["blocks"]
        assert blocks, "no blocks"
        for k, got in blocks.items():
            want = tuple(reference[f"{tag}/{k}{at}"])
            assert got == want, (k, at, got, want)
        # every recorded shard of this device has a block
        want_keys = {k[len(tag) + 1:-len(at)] for k in reference
                     if k.startswith(tag + "/") and k.endswith(at)}
        assert set(blocks) == want_keys, (set(blocks) ^ want_keys)


def check_slot_team(res, name, over, shape, b, max_len):
    """The first decode step's ``pmax`` calls: one per layer over the axes
    of the ring's ``kv_seq`` entry where it splits the slots (the softmax
    combine), plus the greedy token's one over "model" where the
    vocabulary splits; none other."""
    from repro_torch import configs as tconfigs
    from repro_torch.models import lm
    from repro_torch.models.config import spec_axes
    import test_torch_dryrun as td_dry
    cfg = tconfigs.get_smoke(name).with_(dtype="float32", **over)
    mesh = td_dry._MeshStub(shape, ("data", "model"))
    seq = spec_axes(lm.cache_shardings(cfg, mesh, b, max_len)["k"][3])
    sizes = dict(zip(("data", "model"), shape))
    want: dict = {}
    if seq and np.prod([sizes[a] for a in seq]) > 1:
        want[tuple(seq)] = cfg.n_layers
    if shape[1] > 1 and cfg.vocab_pad % shape[1] == 0:
        want[("model",)] = want.get(("model",), 0) + 1
    for r in res:
        got: dict = {}
        for prim, axes, _ in r["events"]:
            if prim == "pmax":
                got[tuple(axes)] = got.get(tuple(axes), 0) + 1
        assert got == want, (r["rank"], got, want)
