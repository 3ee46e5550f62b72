"""The LM zoo's cache-free forward and loss, port against the JAX
reference, on the CPU at smoke sizes.

The same weights (the reference's ``init_params``, carried over with
``convert.lm_params_from_numpy``) and the same numpy tokens go through
``repro.models.lm.loss_fn`` / ``transformer.forward`` and their ports,
for every decoder-only smoke config and every ``attention_impl``, in
float32 and in bfloat16.  L = 64 exceeds the smoke window of 32, so the
sliding window bites.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as tT

import _torch_parity  # noqa: F401  (pins torch to one thread)

DECODERS = ("h2o_danube_1p8b", "qwen2p5_3b", "qwen1p5_110b", "gemma2_27b",
            "chameleon_34b")
LATER = {"mamba2_130m": "SSM", "zamba2_7b": "hybrid",
         "whisper_small": "Whisper"}
IMPLS = ("flash", "ref", "chunked")
B, L = 2, 64

#: float32: the same arithmetic in another library; the loss agrees to
#: ~1e-6 (measured), held at 1e-5, the hidden states at 5e-5 (~10x the
#: measured 5e-6 at |h| < 5)
F32_LOSS_TOL, F32_HIDDEN_TOL = 1e-5, 5e-5
#: bfloat16: the two libraries round matmul outputs, silu and the
#: residual adds in bf16 at slightly different points; over 2 layers the
#: hidden states land up to ~4 bf16 ulps apart (0.06 at |h| ~ 4,
#: measured), held at 8 ulps (0.125); the loss, a mean over 128 tokens in
#: float32, to 2e-4 measured, held at 1e-3
BF16_LOSS_TOL, BF16_HIDDEN_TOL = 1e-3, 0.125


def _cfgs(name, **kw):
    return (jconfigs.get_smoke(name).with_(**kw),
            tconfigs.get_smoke(name).with_(**kw))


def _weights(jcfg, seed=0):
    """The reference's init at ``seed``, with the zero-initialised norm
    scales and biases moved off zero so that they matter."""
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(np.asarray,
                          jT.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        if not a.any() else a, params)


def _tokens(vocab, seed=2):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, L + 1))
    return toks[:, :-1], toks[:, 1:]


def _jax_loss_and_hidden(jcfg, params, tokens, targets):
    def run(p, t, y):
        total, aux = jlm.loss_fn(jcfg, p, jlm.Batch(tokens=t, targets=y))
        h = jT.forward(jcfg, jlm.cast_params(jcfg, p), t, jnp.arange(L))[0]
        return aux["loss"], h.astype(jnp.float32)
    loss, h = jax.jit(run)(params, jnp.asarray(tokens, jnp.int32),
                           jnp.asarray(targets, jnp.int32))
    return float(loss), np.asarray(h)


def _port_loss_and_hidden(tcfg, params, tokens, targets):
    model = convert.lm_params_from_numpy(tcfg, params, device="cpu")
    tok, tgt = torch.as_tensor(tokens), torch.as_tensor(targets)
    total, aux = tlm.loss_fn(tcfg, model, tlm.Batch(tokens=tok, targets=tgt))
    assert float(total) == float(aux["loss"])       # no aux for decoders
    h = tT.forward(tcfg, tlm.cast_params(tcfg, model), tok,
                   torch.arange(L))[0]
    return float(aux["loss"]), h.float().numpy()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", DECODERS)
def test_loss_and_hidden_match_jax(name, impl, dt):
    jcfg, tcfg = _cfgs(name, attention_impl=impl, dtype=dt)
    params = _weights(jcfg)
    tokens, targets = _tokens(jcfg.vocab)
    want_loss, want_h = _jax_loss_and_hidden(jcfg, params, tokens, targets)
    got_loss, got_h = _port_loss_and_hidden(tcfg, params, tokens, targets)
    loss_tol, h_tol = ((F32_LOSS_TOL, F32_HIDDEN_TOL) if dt == "float32"
                       else (BF16_LOSS_TOL, BF16_HIDDEN_TOL))
    assert np.isfinite(got_loss)
    assert abs(got_loss - want_loss) <= loss_tol, (got_loss, want_loss)
    assert got_h.shape == (B, L, jcfg.d_model)
    np.testing.assert_allclose(got_h, want_h, rtol=h_tol, atol=h_tol)


def test_chunked_loss_matches_jax():
    """``loss_chunk`` > 0 takes the sequence-chunked cross entropy in both
    packages (4 chunks of 16) and equals the unchunked loss."""
    jcfg, tcfg = _cfgs("h2o_danube_1p8b", dtype="float32", loss_chunk=16,
                       attention_impl="flash")
    params = _weights(jcfg, seed=3)
    tokens, targets = _tokens(jcfg.vocab, seed=4)
    want, _ = _jax_loss_and_hidden(jcfg, params, tokens, targets)
    got, _ = _port_loss_and_hidden(tcfg, params, tokens, targets)
    whole, _ = _port_loss_and_hidden(tcfg.with_(loss_chunk=0), params,
                                     tokens, targets)
    assert abs(got - want) <= F32_LOSS_TOL
    assert abs(got - whole) <= F32_LOSS_TOL


@pytest.mark.parametrize("name", jconfigs.ARCHS)
def test_configs_equal_reference(name):
    for get in ("get", "get_smoke"):
        j = getattr(jconfigs, get)(name)
        t = getattr(tconfigs, get)(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.hd, t.vocab_pad, t.attn_free) == (j.hd, j.vocab_pad,
                                                    j.attn_free)
        assert t.param_count() == j.param_count()
        assert (t.param_count(active_only=True)
                == j.param_count(active_only=True))
    assert tconfigs.canon(name.replace("_", "-")) == jconfigs.canon(
        name.replace("_", "-"))
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    assert tconfigs.SHAPES == jconfigs.SHAPES


@pytest.mark.parametrize("name", DECODERS)
def test_schema_and_init_match_reference(name):
    """The port's schema tree is the reference's, and ``init_params``
    draws every tensor at its shape and scale (zeros and ones exactly)."""
    jcfg, tcfg = _cfgs(name)
    assert tT.model_schema(tcfg) == jT.model_schema(jcfg)
    model = tT.init_params(tcfg, seed=5, device="cpu")
    tree = model.tree()
    want = jax.tree.map(np.asarray, jT.init_params(jcfg,
                                                   jax.random.PRNGKey(5)))
    for group in ("embed", "final"):
        assert set(tree[group]) == set(want[group])
        for k, v in tree[group].items():
            assert tuple(v.shape) == want[group][k].shape
            assert v.dtype == torch.float32
    assert len(tree["blocks"]) == tcfg.n_layers
    schema = jT.model_schema(jcfg)["blocks"]
    for k, (shape, _, scale) in schema.items():
        got = torch.stack([b[k] for b in tree["blocks"]])
        assert tuple(got.shape) == shape
        if scale == 0.0:
            assert not got.any()
        elif scale != 1.0 or len(shape) > 2:
            assert abs(float(got.std()) - scale) < 0.2 * scale, k
    again = tT.init_params(tcfg, seed=5, device="cpu").tree()
    assert all(torch.equal(a, b) for a, b in
               zip(tree["blocks"][1].values(), again["blocks"][1].values()))


def test_lm_params_from_numpy_unstacks_layers():
    jcfg, tcfg = _cfgs("qwen2p5_3b")
    params = _weights(jcfg)
    model = convert.lm_params_from_numpy(tcfg, params, device="cpu")
    for i, block in enumerate(model.blocks):
        for k, v in block.tensors().items():
            np.testing.assert_array_equal(v.numpy(), params["blocks"][k][i])
            assert not v.requires_grad
    assert "unembed" not in model.embed          # tied embeddings


@pytest.mark.parametrize("name", sorted(LATER))
def test_later_families_raise(name):
    cfg = tconfigs.get_smoke(name)
    with pytest.raises(NotImplementedError, match=LATER[name]):
        tT.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=LATER[name]):
        tT.model_schema(cfg)


def test_cached_paths_and_moe_raise():
    """The cached paths and the MoE layer run (their parity with the
    reference is in ``test_torch_lm_serve.py`` and ``test_torch_moe.py``);
    only the train step still raises."""
    cfg = tconfigs.get_smoke("h2o_danube_1p8b").with_(dtype="float32")
    model = tT.init_params(cfg, device="cpu")
    tok = torch.zeros((1, 8), dtype=torch.long)
    pos = torch.arange(8)
    caches = tT.init_cache(cfg, 1, 16, device="cpu")
    h, out, _ = tT.forward(cfg, model, tok, pos, caches=caches)
    assert out is caches and h.shape == (1, 8, cfg.d_model)
    assert caches["pos"][:, :8].tolist() == [list(range(8))] * cfg.n_layers
    x = torch.zeros((1, 8, cfg.d_model))
    cache = tT.layer_cache(tT.init_cache(cfg, 1, 16, device="cpu"), 0)
    a, c = tL.attention(cfg, model.blocks[0], x, pos, cache=cache)
    assert c is cache and a.shape == x.shape and bool(cache["pos"][7] == 7)
    h, c, aux = tT.apply_decoder_block(cfg, model.blocks[0], x, pos, 32,
                                       cache=cache)
    assert c is cache and h.shape == x.shape and aux == 0.0
    moe = tconfigs.get_smoke("olmoe_1b_7b").with_(dtype="float32")
    m, aux = tL.apply_moe(moe, tT.init_params(moe, device="cpu").blocks[0],
                          torch.zeros((1, 8, moe.d_model)))
    assert m.shape == (1, 8, moe.d_model) and float(aux) > 0
    prefill = tlm.make_prefill(cfg, 16)
    caches, logits = prefill(model, tT.init_cache(cfg, 1, 16, device="cpu"),
                             tok)
    assert logits.shape == (1, cfg.vocab_pad)
    caches, nxt = tlm.make_decode_step(cfg)(model, caches, tok[:, 0], 8)
    assert nxt.shape == (1,) and bool(caches["pos"][0, 8] == 8)
    with pytest.raises(NotImplementedError, match="train-step"):
        tlm.make_train_step(cfg)


def test_flash_route_counts_no_launch_on_the_cpu():
    """On CPU tensors the flash branch runs the kernel's plain version;
    the launch count stays 0 (only a kernel launch counts)."""
    from repro_torch.kernels import ops
    cfg = tconfigs.get_smoke("h2o_danube_1p8b").with_(
        attention_impl="flash", dtype="float32")
    model = tT.init_params(cfg, seed=1, device="cpu")
    tokens, targets = _tokens(cfg.vocab)
    ops.reset_launches()
    total, _ = tlm.loss_fn(cfg, model, tlm.Batch(
        tokens=torch.as_tensor(tokens), targets=torch.as_tensor(targets)))
    assert ops.LAUNCHES["flash_attention"] == 0
    assert abs(float(total) - np.log(cfg.vocab)) < 0.5


def test_init_params_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke("h2o_danube_1p8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tT.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.lm_params_from_numpy(cfg, _weights(_cfgs(
            "h2o_danube_1p8b")[0]))

