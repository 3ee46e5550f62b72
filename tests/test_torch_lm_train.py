"""The LM train step, port against the JAX reference on the CPU at smoke
sizes: the memory-efficient attention's backward against the reference's
custom VJP, ``loss_fn``'s gradients against ``jax.grad`` on all ten
smoke configs (remat off and on, the chunked loss), one
``make_train_step`` and five steps of ``train()`` against the
reference's, the port's own invariants (micro-batching, loss chunking,
remat), and the ``launch.train`` CLI and the training example on the
host.

The same weights (the reference's ``init_params``, carried over with
``convert.lm_params_from_numpy``) and the same numpy tokens and frames
go to both packages, in float32.
"""
import dataclasses
import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import transformer as jT
from repro.train import optim as jopt
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as tT
from repro_torch.train import optim as topt

import _torch_parity  # noqa: F401  (pins torch to one thread)

REPO = Path(__file__).resolve().parents[1]
B, L = 2, 64
#: loss_fn's gradients, per leaf: float32 in two libraries (other
#: reduction orders in the GEMMs and the chunked softmax); measured
#: within 0.08 of this bound on every smoke config (Zamba2's SSD the
#: widest), held at the bound
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
#: the mea backward alone: float32 einsums over <= 48 keys, measured
#: ~1e-7 of max |g|, held at 1e-5
MEA_TOL = 1e-5
#: AdamW's first step is lr * sign(g) wherever |g| >> eps, whatever |g|,
#: so an entry whose gradient is near zero may take the opposite sign in
#: the other library.  The params comparison leaves out the entries whose
#: reference gradient is below SIGN_FRAC of its leaf's max |g|: the
#: gradients agree within GRAD_RTOL (1e-4) of that max, so every entry
#: kept has 10x margin against a sign flip.
SIGN_FRAC = 1e-3


def _cfgs(name, **kw):
    return (jconfigs.get_smoke(name).with_(**kw),
            tconfigs.get_smoke(name).with_(**kw))


def _weights(jcfg, seed=0, max_len=L):
    """The reference's init at ``seed``, the zero-initialised norm scales
    and biases moved off zero so that they matter."""
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(np.asarray, jT.init_params(
        jcfg, jax.random.PRNGKey(seed), max_len=max_len))
    return jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        if not a.any() else a, params)


def _batch(cfg, b=B, length=L, seed=2):
    """(tokens, targets, frames) as numpy; frames None unless enc-dec."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (b, length + 1))
    frames = (np.random.default_rng(seed + 1).standard_normal(
        (b, cfg.enc_len, cfg.d_model)).astype(np.float32)
        if cfg.enc_dec else None)
    return toks[:, :-1], toks[:, 1:], frames


def _jbatch(arrs):
    t, y, f = arrs
    return jlm.Batch(jnp.asarray(t, jnp.int32), jnp.asarray(y, jnp.int32),
                     None if f is None else jnp.asarray(f))


def _tbatch(arrs):
    t, y, f = arrs
    return tlm.Batch(torch.as_tensor(t, dtype=torch.int32),
                     torch.as_tensor(y, dtype=torch.int32),
                     None if f is None else torch.as_tensor(f))


def _jax_grads(jcfg, params, arrs):
    (total, aux), g = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, _jbatch(arrs)), has_aux=True))(params)
    return float(aux["loss"]), jax.tree.map(np.asarray, g)


def _port_grads(tcfg, params, arrs):
    model = convert.lm_params_from_numpy(tcfg, params, device="cpu")
    model.requires_grad_(True)
    (total, aux), g = topt.accumulate_gradients(
        partial(tlm.loss_fn, tcfg), model, _tbatch(arrs), 1)
    return float(aux["loss"]), convert.lm_params_to_numpy(g)


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for group in want:
        assert set(got[group]) == set(want[group]), group
        for k, w in want[group].items():
            g = got[group][k]
            assert g.shape == w.shape, (group, k)
            tol = GRAD_RTOL * np.abs(w).max() + GRAD_ATOL
            err = np.abs(g - w).max()
            assert err <= tol, (group, k, err, tol)


# ---------------------------------------------------------------------------
# the memory-efficient attention's backward
# ---------------------------------------------------------------------------

MEA_CASES = {
    # name: (Hq, Hkv, Lq = Lk, causal, window, softcap, chunk)
    "causal": (4, 4, 48, True, 0, None, 16),
    "window": (4, 4, 48, True, 12, None, 16),
    "bidirectional": (4, 4, 48, False, 0, None, 16),
    "gqa": (4, 2, 48, True, 0, None, 16),
    "softcap": (4, 4, 48, True, 0, 5.0, 16),
    # 37 keys: _pick_chunk's largest divisor <= 16 is 1, one-key chunks
    "prime_keys": (4, 2, 37, True, 9, 5.0, tL._pick_chunk(37, 16)),
}


def _mea_inputs(hq, hkv, n, seed=0, d=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, hq, n, d)).astype(np.float32) * 2.0
    k = rng.standard_normal((2, hkv, n, d)).astype(np.float32) * 2.0
    v = rng.standard_normal((2, hkv, n, d)).astype(np.float32)
    dout = rng.standard_normal((2, hq, n, d)).astype(np.float32)
    return q, k, v, dout


@pytest.mark.parametrize("case", sorted(MEA_CASES))
def test_mea_backward_matches_reference_vjp(case):
    """dq, dk, dv of ``mea_attention`` (the grouped keys and values
    repeated up to the query heads before it, as ``attention`` does)
    against ``jax.vjp`` of the reference's custom-VJP version."""
    hq, hkv, n, causal, window, softcap, chunk = MEA_CASES[case]
    q, k, v, dout = _mea_inputs(hq, hkv, n)
    d = q.shape[-1]
    pos = np.arange(n)
    group = hq // hkv

    def jfn(q, k, v):
        k, v = jnp.repeat(k, group, axis=1), jnp.repeat(v, group, axis=1)
        return jL.mea_attention(q, k, v, jnp.asarray(pos), jnp.asarray(pos),
                                jnp.asarray(window, jnp.int32), causal,
                                d ** -0.5, softcap, chunk)
    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(dout))]

    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tL.mea_attention(
        qt, torch.repeat_interleave(kt, group, dim=1),
        torch.repeat_interleave(vt, group, dim=1), torch.as_tensor(pos),
        torch.as_tensor(pos), window, causal, d ** -0.5, softcap, chunk)
    assert out.grad_fn is not None
    out.backward(torch.as_tensor(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=MEA_TOL, atol=MEA_TOL)
    for name, t, w in zip("qkv", (qt, kt, vt), want):
        tol = MEA_TOL * np.abs(w).max()
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0, atol=tol,
                                   err_msg=f"d{name}")
    with torch.no_grad():
        again = tL.mea_attention(
            qt, torch.repeat_interleave(kt, group, dim=1),
            torch.repeat_interleave(vt, group, dim=1), torch.as_tensor(pos),
            torch.as_tensor(pos), window, causal, d ** -0.5, softcap, chunk)
    assert again.grad_fn is None and torch.equal(again, out.detach())


def test_mea_backward_saves_no_chunk_probabilities():
    """What the forward saves for the backward: q, k, v, the output, the
    log-sum-exp and the positions, O(L * D), never a (B, H, Lq, chunk)
    block of probabilities; autograd through the plain chunk loop would
    save every chunk's."""
    q, k, v, _ = _mea_inputs(4, 4, 64, d=4)
    pos = torch.arange(64)

    def saved_by(fn):
        sizes = []

        def pack(t):
            sizes.append(t.numel())
            return t
        qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn(qt, kt, vt, pos, pos, 0, True, 0.5, None, 16)
        return sizes
    custom = saved_by(tL.mea_attention)
    plain = saved_by(tL._mea_forward)
    chunk_block = 2 * 4 * 64 * 16
    assert max(custom) == q.size < chunk_block
    assert sum(custom) == 4 * q.size + 2 * 4 * 64 + 2 * 64
    assert sum(1 for n in plain if n >= chunk_block) >= 4


def test_flash_route_refuses_gradients():
    """The flash kernel has no backward (nor has the reference's Pallas
    kernel): a train step on that route, or gradients through it, are
    refused rather than silently cut."""
    _, tcfg = _cfgs("h2o_danube_1p8b", dtype="float32",
                    attention_impl="flash")
    model = tT.init_params(tcfg, seed=0, device="cpu")
    state = tlm.init_train_state(model, topt.AdamW())
    tok = torch.zeros((1, 8), dtype=torch.int32)
    step = tlm.make_train_step(tcfg, topt.AdamW(), lambda s: 1e-3)
    with pytest.raises(ValueError, match="flash"):
        step(state, tlm.Batch(tok, tok))
    with pytest.raises(ValueError, match="flash"):
        tlm.loss_fn(tcfg, model, tlm.Batch(tok, tok))
    with torch.no_grad():
        tlm.loss_fn(tcfg, model, tlm.Batch(tok, tok))


# ---------------------------------------------------------------------------
# loss_fn's gradients against jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", jconfigs.ARCHS)
def test_loss_grads_match_jax(name):
    """Every leaf of ``loss_fn``'s gradient against ``jax.grad`` of the
    reference's, float32, remat off and on (the port's checkpointed
    layers give the same numbers), and the loss."""
    jcfg, tcfg = _cfgs(name, dtype="float32")
    params = _weights(jcfg)
    arrs = _batch(jcfg)
    want_loss, want = _jax_grads(jcfg, params, arrs)
    for remat in (False, True):
        got_loss, got = _port_grads(tcfg.with_(remat=remat), params, arrs)
        assert abs(got_loss - want_loss) <= 1e-5, (remat, got_loss)
        _assert_grads_close(got, want)


@pytest.mark.parametrize("name", ["h2o_danube_1p8b", "gemma2_27b"])
def test_loss_chunk_grads_match_jax(name):
    """``loss_chunk`` = 16 of L = 64 (four checkpointed chunks; gemma2's
    final softcap inside each), remat on, against the reference's
    checkpointed scan."""
    jcfg, tcfg = _cfgs(name, dtype="float32", loss_chunk=16, remat=True)
    params = _weights(jcfg, seed=3)
    arrs = _batch(jcfg, seed=4)
    want_loss, want = _jax_grads(jcfg, params, arrs)
    got_loss, got = _port_grads(tcfg, params, arrs)
    assert abs(got_loss - want_loss) <= 1e-5
    _assert_grads_close(got, want)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_smoke_train_step(arch):
    """Reduced config in its own compute dtype: one train step, finite
    loss and grad norm, shapes kept, params changed in place, the step
    counters advanced, the metrics device scalars."""
    cfg = tconfigs.get_smoke(arch)
    model = tT.init_params(cfg, seed=0, max_len=64, device="cpu")
    before = [t.detach().clone() for t in topt.tree_leaves(model.tree())]
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 32)),
                             dtype=torch.int32)
    frames = (torch.zeros((2, cfg.enc_len, cfg.d_model),
                          dtype=getattr(torch, cfg.dtype))
              if cfg.enc_dec else None)
    opt = topt.AdamW()
    state = tlm.init_train_state(model, opt)
    step = tlm.make_train_step(cfg, opt, lambda s: 1e-3)
    new_state, metrics = step(state, tlm.Batch(tokens, tokens, frames))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert set(metrics) == {"loss", "aux_loss", "grad_norm", "lr"}
    after = topt.tree_leaves(new_state.params.tree())
    assert all(a.shape == b.shape for a, b in zip(before, after))
    assert any(not torch.equal(a, b) for a, b in zip(before, after))
    assert new_state.params is model
    assert int(new_state.step) == 1 and int(new_state.opt.step) == 1
    assert all(p.grad is None for p in model.parameters())


def test_microbatch_invariant():
    """Gradient accumulation over micro-batches == full-batch step."""
    cfg = tconfigs.get_smoke("h2o_danube_1p8b").with_(dtype="float32")
    model = tT.init_params(cfg, seed=6, device="cpu").requires_grad_(True)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 16)), dtype=torch.int32)
    batch = tlm.Batch(tokens, tokens)
    (l1, _), g1 = topt.accumulate_gradients(partial(tlm.loss_fn, cfg),
                                            model, batch, 1)
    (l2, _), g2 = topt.accumulate_gradients(partial(tlm.loss_fn, cfg),
                                            model, batch, 4)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for a, b in zip(topt.tree_leaves(g1), topt.tree_leaves(g2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5)


def test_loss_chunking_invariant():
    """The chunked loss equals the whole one, its gradients too."""
    cfg = tconfigs.get_smoke("qwen2p5_3b").with_(dtype="float32")
    model = tT.init_params(cfg, seed=5, device="cpu").requires_grad_(True)
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 32)), dtype=torch.int32)
    batch = tlm.Batch(tokens, tokens)
    out = {}
    for chunk in (0, 8):
        out[chunk] = topt.accumulate_gradients(
            partial(tlm.loss_fn, cfg.with_(loss_chunk=chunk)), model, batch,
            1)
    (l0, _), g0 = out[0]
    (l1, _), g1 = out[8]
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-5)
    for a, b in zip(topt.tree_leaves(g0), topt.tree_leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_remat_recomputes_layers_only_under_gradients(monkeypatch):
    """With ``remat`` each layer's forward runs once more in the backward
    (4 + 4 calls); with ``remat_group`` 2 of 4 layers each group's
    forward runs again besides (more than 8 calls: how many of its
    layers the recompute reaches is the checkpoint's early stop); the
    gradients are the same.  Without gradients, or on the serve path,
    nothing is recomputed."""
    cfg = tconfigs.get_smoke("h2o_danube_1p8b").with_(
        dtype="float32", n_layers=4, remat=True)
    calls = {"n": 0}
    real = tT.apply_decoder_block

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(tT, "apply_decoder_block", counted)
    model = tT.init_params(cfg, seed=0, device="cpu").requires_grad_(True)
    tok = torch.zeros((1, 16), dtype=torch.int32)
    batch = tlm.Batch(tok, tok)
    counts, grads = {}, {}
    for group in (0, 2):
        calls["n"] = 0
        (_, _), grads[group] = topt.accumulate_gradients(
            partial(tlm.loss_fn, cfg.with_(remat_group=group)), model, batch,
            1)
        counts[group] = calls["n"]
    assert counts[0] == 8 and counts[2] > 8, counts
    for a, b in zip(topt.tree_leaves(grads[0]), topt.tree_leaves(grads[2])):
        assert torch.equal(a, b)
    calls["n"] = 0
    with torch.no_grad():
        tlm.loss_fn(cfg, model, batch)
    assert calls["n"] == 4
    calls["n"] = 0
    cache = tT.init_cache(cfg, 1, 16, device="cpu")
    tlm.make_prefill(cfg, 16)(tlm.cast_params(cfg, model), cache, tok)
    assert calls["n"] == 4


def test_train_step_matches_reference():
    """One ``make_train_step`` from the same weights on the same batch,
    two micro-batches: the loss and the grad norm within 1e-5, the step
    counters, and the updated params wherever the reference's gradient
    is at least SIGN_FRAC of its leaf's max or exactly zero (AdamW's first
    step there is lr * sign(g) + decay, within 1e-6); under 2% of the
    entries are left out."""
    jcfg, tcfg = _cfgs("h2o_danube_1p8b", dtype="float32")
    params = _weights(jcfg, seed=4)
    arrs = _batch(jcfg, b=4, length=32, seed=5)
    _, jg = _jax_grads(jcfg, params, arrs)
    sched = (jopt.cosine_schedule(1e-3, 0, 10),
             topt.cosine_schedule(1e-3, 0, 10))
    jopt_ = jopt.AdamW()
    jstate = jlm.TrainState(jax.tree.map(jnp.asarray, params),
                            jopt_.init(params), jnp.zeros((), jnp.int32))
    jnew, jm = jax.jit(jlm.make_train_step(jcfg, jopt_, sched[0],
                                           n_micro=2))(jstate,
                                                       _jbatch(arrs))
    model = convert.lm_params_from_numpy(tcfg, params, device="cpu")
    state = tlm.init_train_state(model, topt.AdamW())
    tnew, tm = tlm.make_train_step(tcfg, topt.AdamW(), sched[1],
                                   n_micro=2)(state, _tbatch(arrs))
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(tm[key]) - float(jm[key])) <= 1e-5 * max(
            1.0, abs(float(jm[key]))), key
    assert int(tnew.step) == int(jnew.step) == 1
    got = convert.train_state_to_numpy(tnew)["params"]
    want = jax.tree.map(np.asarray, jnew.params)
    left_out = total = 0
    for group in want:
        for k, w in want[group].items():
            g_ref = np.abs(jg[group][k])
            # an exact zero (an embedding row no token of the batch
            # reads) is a zero in both packages: decay only
            keep = (g_ref >= SIGN_FRAC * g_ref.max()) | (g_ref == 0)
            left_out += int((~keep).sum())
            total += keep.size
            np.testing.assert_allclose(got[group][k][keep], w[keep],
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{group}/{k}")
    assert left_out < 0.02 * total, (left_out, total)


def test_train_losses_match_reference():
    """Five steps of ``train()`` from the same weights on the same data
    (the reference's ``make_source``, bit-equal) against the
    reference's ``train()``: the losses agree within 2e-4.  Past the
    first step the entries whose tiny gradients took the other sign (see
    SIGN_FRAC) have moved 2 lr apart, so the losses part by ~1e-5."""
    from repro.train import loop as jloop
    from repro_torch.train import loop as tloop
    jcfg, tcfg = _cfgs("h2o_danube_1p8b", dtype="float32")
    params = _weights(jcfg, seed=2, max_len=32)
    kw = dict(seq_len=32, global_batch=2, steps=5, peak_lr=1e-3, warmup=2,
              log_every=0)
    jopt_ = jopt.AdamW()
    jstate = jlm.TrainState(jax.tree.map(jnp.asarray, params),
                            jopt_.init(params), jnp.zeros((), jnp.int32))
    want = jloop.train(jcfg, jloop.TrainerConfig(**kw), state=jstate,
                       log=lambda *a: None)
    state = tlm.init_train_state(
        convert.lm_params_from_numpy(tcfg, params, device="cpu"),
        topt.AdamW())
    got = tloop.train(tcfg, tloop.TrainerConfig(**kw), state=state,
                      log=lambda *a: None, device="cpu")
    assert got.final_step == want.final_step == 5
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=2e-4)
    assert got.state.params is state.params and int(got.state.step) == 5


# ---------------------------------------------------------------------------
# the CLI and the example on the host
# ---------------------------------------------------------------------------

def test_launch_train_cli_resumes(tmp_path, capsys):
    """``launch.train`` on the host: 4 smoke steps with checkpoints, then
    the same command to step 8 on the one-process host mesh resumes from
    step 4 (4 more losses); the production meshes raise, naming the
    rank count they need."""
    from repro_torch.launch import train as cli
    argv = ["--arch", "mamba2-130m", "--smoke", "--seq-len", "32",
            "--batch", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "2", "--mesh", "none"]
    res = cli.main(argv + ["--steps", "4"], device="cpu")
    assert res.final_step == 4 and len(res.losses) == 4
    res2 = cli.main(argv + ["--steps", "8", "--mesh", "host"], device="cpu")
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "done: 8 steps" in out
    assert res2.final_step == 8 and len(res2.losses) == 4
    for mesh, need in (("pod", 256), ("multipod", 512)):
        with pytest.raises(ValueError, match=f"needs {need} ranks"):
            cli.main(argv + ["--mesh", mesh], device="cpu")


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lm_train_example_main_on_the_cpu(tmp_path, capsys):
    """``examples/torch_lm_train.py``'s ``main`` on the host with its
    gate (the loss drops by 0.5), its model and trainer overridden here
    to a smoke config of its family (the example's own is ~100M
    parameters); its checkpoints land in ``--ckpt-dir``."""
    ex = _load_example("torch_lm_train")
    full = ex.model_config()
    assert (full.n_layers, full.d_model, full.window) == (12, 512, 256)
    base = ex.trainer_config
    ex.model_config = lambda: tconfigs.get_smoke(
        "h2o_danube_1p8b").with_(dtype="float32")
    ex.trainer_config = lambda steps, d: dataclasses.replace(
        base(steps, d), seq_len=32, warmup=5, ckpt_every=20, log_every=20,
        peak_lr=1e-2)
    res = ex.main(["--steps", "40", "--ckpt-dir", str(tmp_path)],
                  device="cpu")
    assert res.losses[-1] < res.losses[0] - 0.5
    from repro_torch.train import checkpoint as ckpt
    assert ckpt.latest_step(str(tmp_path)) == 40
    assert (tmp_path / "heartbeat.json").exists()
    assert "did not learn" not in capsys.readouterr().out
