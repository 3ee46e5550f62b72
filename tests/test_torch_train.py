"""The training substrate, port against the JAX reference on the CPU:
optimizers, schedules, clipping and accumulation fed the same numpy
values, the data pipeline bit for bit, checkpoints crossing between the
packages both ways, and the fault machinery.  Mirrors
``tests/test_train.py`` test for test."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # minimal CPU image — deterministic fallback
    from _hypothesis_fallback import given, settings, st

from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optim as jopt
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as tT
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optim as topt
from repro_torch.train.data import SyntheticFrames, SyntheticLM
from repro_torch.train.fault import Heartbeat, StragglerMonitor, retry
from repro_torch.train.optim import (AdamW, SGDM, accumulate_gradients,
                                     clip_by_global_norm, cosine_schedule,
                                     global_norm, linear_schedule)

import _torch_parity  # noqa: F401  (pins torch to one thread)

#: one optimizer step in float32 in two libraries: the same formulas,
#: rounded at the same points; measured agreement ~1e-8, held at 1e-6
OPT_TOL = 1e-6


def _np_tree(seed, scale=1.0):
    """A small parameter-shaped tree of float32 numpy arrays: a nested
    dict and a stacked group."""
    rng = np.random.default_rng(seed)
    return {"a": {"w": (scale * rng.standard_normal((3, 4))).astype(
                np.float32),
                  "b": (scale * rng.standard_normal(4)).astype(np.float32)},
            "z": (scale * rng.standard_normal((2, 5))).astype(np.float32)}


def _t(tree, requires_grad=False):
    return topt.tree_map(lambda a: torch.tensor(
        a, requires_grad=requires_grad), tree)


def _assert_tree_close(got, want, tol):
    got = topt.tree_map(lambda t: t.detach().numpy(), got)
    for g, w in zip(topt.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=tol, atol=tol)


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = AdamW(lr=0.1, weight_decay=0.0, clip_norm=100.0)
    state = opt.init(params)
    for _ in range(300):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_weight_decay_shrinks():
    params = {"w": torch.ones(4) * 10.0}
    opt = AdamW(lr=0.01, weight_decay=0.5, clip_norm=100.0)
    state = opt.init(params)
    for _ in range(50):
        params, state, _ = opt.update({"w": torch.zeros(4)}, state, params)
    assert float(params["w"].max()) < 10.0


def test_sgdm_minimizes_quadratic():
    params = {"w": torch.tensor([4.0])}
    opt = SGDM(lr=0.05)
    state = opt.init(params)
    for _ in range(200):
        params, state, _ = opt.update({"w": 2 * params["w"]}, state, params)
    assert abs(float(params["w"][0])) < 1e-2


@pytest.mark.parametrize("kind", ["adamw", "sgdm"])
def test_optimizer_updates_match_the_reference(kind):
    """Five steps of each package's optimizer fed the same numpy
    gradients (large enough that the clip bites on some) at the
    schedule's learning rate: params, moments, step and grad norm."""
    sched_j = jopt.cosine_schedule(0.05, 2, 5)
    sched_t = cosine_schedule(0.05, 2, 5)
    jo, to = ((jopt.AdamW(), AdamW()) if kind == "adamw"
              else (jopt.SGDM(), SGDM()))
    jp = jax.tree.map(jnp.asarray, _np_tree(0))
    tp = _t(_np_tree(0))
    js, ts = jo.init(jp), to.init(tp)
    for i in range(5):
        g = _np_tree(10 + i, scale=0.2 * (i + 1))
        jp, js, jn = jo.update(jax.tree.map(jnp.asarray, g), js, jp,
                               lr=sched_j(js.step))
        tp, ts, tn = to.update(_t(g), ts, tp, lr=sched_t(ts.step))
        assert abs(float(tn) - float(jn)) <= OPT_TOL * max(1.0, float(jn))
    assert int(ts.step) == int(js.step) == 5
    _assert_tree_close(tp, jp, OPT_TOL)
    _assert_tree_close(ts.m, js.m, OPT_TOL)
    if kind == "adamw":
        _assert_tree_close(ts.v, js.v, OPT_TOL)
    assert all(t.dtype == torch.float32 for t in topt.tree_leaves(ts.m))


def test_clip_by_global_norm():
    tree = {"a": torch.ones(100) * 10}
    clipped, g = clip_by_global_norm(tree, 1.0)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)
    assert float(g) == pytest.approx(100.0, rel=1e-5)
    tree = _np_tree(3, scale=2.0)
    for max_norm in (0.5, 1e3):
        want, wn = jopt.clip_by_global_norm(
            jax.tree.map(jnp.asarray, tree), max_norm)
        got, gn = clip_by_global_norm(_t(tree), max_norm)
        assert float(gn) == pytest.approx(float(wn), rel=1e-6)
        _assert_tree_close(got, want, 1e-6)


def test_schedules():
    lr = cosine_schedule(1.0, 10, 100)
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(1.0, rel=1e-3)
    assert float(lr(100)) == pytest.approx(0.1, rel=1e-2)  # min_frac
    lin = linear_schedule(1.0, 10, 100)
    assert float(lin(55)) == pytest.approx(0.5, rel=1e-2)
    steps = np.arange(0, 121)
    for mine, ref in ((cosine_schedule(3e-4, 10, 100),
                       jopt.cosine_schedule(3e-4, 10, 100)),
                      (linear_schedule(1e-3, 7, 90),
                       jopt.linear_schedule(1e-3, 7, 90))):
        got = mine(torch.as_tensor(steps, dtype=torch.int32)).numpy()
        want = np.asarray(jax.vmap(ref)(jnp.asarray(steps, jnp.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert mine(torch.tensor(3, dtype=torch.int32)).dtype == \
            torch.float32


@given(st.integers(0, 100), st.integers(0, 100))
@settings(max_examples=10, deadline=None)
def test_data_pipeline_deterministic(step, other):
    """batch_at(step) is a pure function, and the reference's draw bit
    for bit."""
    src = SyntheticLM(vocab=100, seq_len=16, global_batch=2, seed=1)
    a = src.batch_at(step, device="cpu")
    b = src.batch_at(step, device="cpu")
    assert torch.equal(a.tokens, b.tokens)
    want = jdata.SyntheticLM(vocab=100, seq_len=16, global_batch=2,
                             seed=1).batch_at(step)
    np.testing.assert_array_equal(a.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(a.targets.numpy(),
                                  np.asarray(want.targets))
    assert a.tokens.dtype == torch.int32
    if step != other:
        c = src.batch_at(other, device="cpu")
        assert not torch.equal(a.tokens, c.tokens)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_data_sources_equal_the_reference(dtype):
    """``batch_at`` at an LM's vocab and ``frames_at`` in both dtypes
    are the reference's bits; ``make_source`` pairs them for an enc-dec
    config; ``device_batch_at`` keeps the structure (deterministic,
    in range, shifted targets)."""
    src = SyntheticLM(vocab=32000, seq_len=64, global_batch=3, seed=4)
    want = jdata.SyntheticLM(32000, 64, 3, 4).batch_at(9)
    got = src.batch_at(9, device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    fr = SyntheticFrames(24, 16, 2, seed=5).frames_at(
        3, getattr(torch, dtype), device="cpu")
    fw = np.asarray(jdata.SyntheticFrames(24, 16, 2, seed=5).frames_at(
        3, jnp.dtype(dtype)))
    assert fr.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(fr.float().numpy(), fw.astype(np.float32))
    cfg = tconfigs.get_smoke("whisper_small")
    from repro_torch.train.data import make_source
    b = make_source(cfg, 16, 2, seed=1, device="cpu")(2)
    jb = jdata.make_source(__import__("repro.configs", fromlist=["x"])
                           .get_smoke("whisper_small"), 16, 2, seed=1)(2)
    np.testing.assert_array_equal(b.tokens.numpy(), np.asarray(jb.tokens))
    np.testing.assert_array_equal(b.frames.float().numpy(),
                                  np.asarray(jb.frames).astype(np.float32))
    d1, d2 = src.device_batch_at(5, "cpu"), src.device_batch_at(5, "cpu")
    assert torch.equal(d1.tokens, d2.tokens)
    assert not torch.equal(d1.tokens, src.device_batch_at(6, "cpu").tokens)
    assert int(d1.tokens.min()) >= 0 and int(d1.tokens.max()) < 32000
    assert torch.equal(d1.targets[:, :-1], d1.tokens[:, 1:])
    assert not d1.targets[:, -1].any()


def test_data_targets_are_shifted():
    src = SyntheticLM(vocab=100, seq_len=16, global_batch=2, seed=1)
    b = src.batch_at(0, device="cpu")
    assert torch.equal(b.targets[:, :-1], b.tokens[:, 1:])


def test_checkpoint_roundtrip(tmp_path):
    """The port's own round trip, and both packages' checkpoints of the
    same tree (float32 and bfloat16 leaves) restored by the other."""
    state = {"a": torch.arange(6).reshape(2, 3).float(),
             "nested": {"b": (torch.arange(4) / 3).to(torch.bfloat16)}}
    ckpt.save(str(tmp_path / "t"), 7, state, data_cursor=7)
    template = topt.tree_map(torch.zeros_like, state)
    restored, manifest = ckpt.restore(str(tmp_path / "t"), template)
    assert manifest["step"] == 7 and manifest["data_cursor"] == 7
    for a, b in zip(topt.tree_leaves(state), topt.tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the port's checkpoint, restored by the reference
    jtemplate = {"a": jax.ShapeDtypeStruct((2, 3), jnp.float32),
                 "nested": {"b": jax.ShapeDtypeStruct((4,), jnp.bfloat16)}}
    jr, jm = jckpt.restore(str(tmp_path / "t"), jtemplate)
    assert jm == manifest
    np.testing.assert_array_equal(np.asarray(jr["a"]), state["a"].numpy())
    assert jr["nested"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(jr["nested"]["b"]).astype(np.float32),
        state["nested"]["b"].float().numpy())
    # the reference's checkpoint, restored by the port
    jstate = {"a": jnp.arange(6.0).reshape(2, 3) + 0.5,
              "nested": {"b": (jnp.arange(4) / 7).astype(jnp.bfloat16)}}
    jckpt.save(str(tmp_path / "j"), 3, jstate)
    got, _ = ckpt.restore(str(tmp_path / "j"),
                          topt.tree_map(torch.zeros_like, state))
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(jstate["a"]))
    np.testing.assert_array_equal(
        got["nested"]["b"].float().numpy(),
        np.asarray(jstate["nested"]["b"]).astype(np.float32))


def _port_train_state(cfg, seed=0):
    """A smoke model's train state after one AdamW step, so the moments
    and the step counters are not zero."""
    model = tT.init_params(cfg, seed=seed, max_len=16, device="cpu")
    opt = AdamW()
    state = tlm.init_train_state(model, opt)
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, 16)), dtype=torch.int32)
    frames = (torch.zeros((2, cfg.enc_len, cfg.d_model)) if cfg.enc_dec
              else None)
    step = tlm.make_train_step(cfg, opt, lambda s: 1e-3)
    state, _ = step(state, tlm.Batch(toks, toks, frames))
    return state


@pytest.mark.parametrize("name", ["h2o_danube_1p8b", "whisper_small"])
def test_train_state_checkpoint_crosses_both_ways(tmp_path, name):
    """A port ``TrainState`` (a smoke model, AdamW's state after one step)
    saved by the port and restored by ``repro.train.checkpoint.restore``
    into the reference's ``TrainState`` template, leaf for leaf (the
    stacked ``blocks`` / ``enc`` on the layer axis, the step counters);
    and the reference's checkpoint of that state restored by the port
    into a fresh port state, bit for bit."""
    from repro import configs as jconfigs
    from repro.models import lm as jlm, transformer as jT
    cfg = tconfigs.get_smoke(name).with_(dtype="float32")
    jcfg = jconfigs.get_smoke(name).with_(dtype="float32")
    state = _port_train_state(cfg)
    want = convert.train_state_to_numpy(state)
    ckpt.save(str(tmp_path / "port"), 1, state, data_cursor=1)
    names = json.load(open(tmp_path / "port" / "step_00000001" /
                           "manifest.json"))["leaves"]
    assert "params//blocks//ln1_scale" in names and "opt//step" in names
    assert "step" in names and "opt//v//embed//tok" in names
    params = jax.eval_shape(lambda: jT.init_params(
        jcfg, jax.random.PRNGKey(0), max_len=16))
    opt_s = jax.eval_shape(jopt.AdamW().init, params)
    template = jlm.TrainState(params, opt_s,
                              jax.ShapeDtypeStruct((), jnp.int32))
    got, _ = jckpt.restore(str(tmp_path / "port"), template)
    flat_want = jax.tree.leaves(jlm.TrainState(
        want["params"], jopt.AdamWState(**want["opt"]), want["step"]))
    flat_got = jax.tree.leaves(got)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), w)
    # the reference writes the same tree; the port restores it
    jckpt.save(str(tmp_path / "ref"), 1, got)
    fresh = tlm.init_train_state(
        tT.init_params(cfg, seed=9, max_len=16, device="cpu"), AdamW())
    back, manifest = ckpt.restore(str(tmp_path / "ref"), fresh)
    assert manifest["step"] == 1
    again = convert.train_state_to_numpy(back)
    for g, w in zip(jax.tree.leaves(again), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)


def test_checkpoint_gc_keeps_latest(tmp_path):
    state = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, state, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    steps = sorted(os.listdir(tmp_path))
    assert len(steps) == 2
    assert ckpt.latest_step(str(tmp_path / "absent")) is None
    assert jckpt.latest_step(str(tmp_path)) == 5


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    """No ``.tmp`` directory is left, and a stale one from a crashed save
    is neither counted as a step nor kept."""
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert ckpt.latest_step(str(tmp_path)) is None
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(2)})
    ckpt.save(str(tmp_path), 9, {"a": torch.zeros(2)})
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    assert ckpt.latest_step(str(tmp_path)) == 9


def test_elastic_restore_reshards(tmp_path):
    """A checkpoint saved by the reference from a mesh restores in the
    port (one device): the manifest's mesh is advisory only; a template
    leaf of another shape or dtype is refused."""
    from jax.sharding import Mesh
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jstate = {"w": jnp.arange(16, dtype=jnp.float32).reshape(4, 4)}
    jckpt.save(str(tmp_path), 3, jstate, mesh=mesh)
    restored, manifest = ckpt.restore(str(tmp_path),
                                      {"w": torch.zeros(4, 4)})
    assert manifest["mesh_shape"] == {"data": 1}
    np.testing.assert_array_equal(restored["w"].numpy(),
                                  np.asarray(jstate["w"]))
    with pytest.raises(ValueError, match="w"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(2, 8)})
    with pytest.raises(ValueError, match="w"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(4, 4,
                                                      dtype=torch.float64)})
    with pytest.raises(KeyError, match="u"):
        ckpt.restore(str(tmp_path), {"u": torch.zeros(4, 4)})


def test_heartbeat(tmp_path):
    hb = Heartbeat(str(tmp_path / "hb.json"))
    hb.beat(10, {"loss": 1.5})
    rec = hb.read()
    assert rec["step"] == 10 and rec["loss"] == 1.5
    assert not hb.is_stale(60.0)
    assert hb.is_stale(-1.0)
    assert Heartbeat(str(tmp_path / "none.json")).read() is None


def test_straggler_monitor():
    mon = StragglerMonitor(threshold=2.0)
    flags = [mon.record(0.1) for _ in range(10)]
    assert not any(flags)
    assert mon.record(1.0)  # 10x slower than ewma
    assert mon.median == pytest.approx(0.1)


def test_retry_recovers():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return 42

    assert retry(flaky, attempts=5, backoff_s=0.0) == 42
    with pytest.raises(OSError):
        retry(lambda: (_ for _ in ()).throw(OSError("x")), attempts=2,
              backoff_s=0.0)


def test_preemption_checkpoint_resume(tmp_path, monkeypatch):
    """Simulated preemption: guard flag set mid-run -> checkpoint written
    -> a second trainer resumes from it and finishes."""
    import repro_torch.train.loop as loop_mod
    from repro_torch.train.loop import TrainerConfig, train
    cfg = tconfigs.get_smoke("mamba2_130m")
    tc = TrainerConfig(seq_len=32, global_batch=2, steps=10,
                       ckpt_dir=str(tmp_path), ckpt_every=100,
                       log_every=0, peak_lr=1e-3)

    class FakeGuard:
        def __init__(self):
            self.n = 0

        def install(self):
            return self

        def uninstall(self):
            pass

        @property
        def should_stop(self):
            self.n += 1
            return self.n >= 3

    monkeypatch.setattr(loop_mod, "PreemptionGuard", FakeGuard)
    res1 = train(cfg, tc, device="cpu")
    monkeypatch.undo()
    assert res1.preempted and res1.final_step < 10
    assert ckpt.latest_step(str(tmp_path)) == res1.final_step
    res2 = train(cfg, tc, device="cpu")
    assert res2.final_step == 10 and not res2.preempted
    assert len(res2.losses) == 10 - res1.final_step


def test_accumulate_gradients_shapes():
    def loss(params, batch):
        return torch.mean((params["w"] * batch["x"]) ** 2), {}

    def jloss(params, batch):
        return jnp.mean((params["w"] * batch["x"]) ** 2), {}
    params = {"w": torch.ones(3, requires_grad=True)}
    batch = {"x": torch.arange(12.0).reshape(4, 3)}
    (l1, _), g1 = accumulate_gradients(loss, params, batch, 1)
    (l2, _), g2 = accumulate_gradients(loss, params, batch, 2)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    np.testing.assert_allclose(g1["w"].numpy(), g2["w"].numpy(), rtol=1e-5)
    (jl, _), jg = jopt.accumulate_gradients(
        jloss, {"w": jnp.ones(3)}, {"x": jnp.arange(12.0).reshape(4, 3)}, 2)
    assert float(l2) == pytest.approx(float(jl), rel=1e-6)
    np.testing.assert_allclose(g2["w"].numpy(), np.asarray(jg["w"]),
                               rtol=1e-6)
    assert g2["w"].dtype == torch.float32 and params["w"].grad is None
    with pytest.raises(ValueError, match="require grad"):
        accumulate_gradients(loss, {"w": torch.ones(3)}, batch, 2)
