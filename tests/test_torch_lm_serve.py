"""The LM zoo's serve path, port against the JAX reference, on the CPU at
smoke sizes: ``transformer.init_cache``, the cached ``layers.attention``
(single-shot prefill, chunked prefill, decode over the ring), the
Mamba2 block's conv and state cache, Whisper's stored encoder output,
``lm.make_prefill`` / ``make_decode_step`` and ``launch.serve.serve_batch``
for every family of the zoo.

Both packages get the same weights (the reference's ``init_params`` with
the zero-initialised norms moved off zero, carried over with
``convert.lm_params_from_numpy``), the same numpy tokens (and Whisper's
seeded frames), and, where a test says so, the same cache
(``convert.cache_from_numpy``).  L = 40 exceeds the smoke window of 32,
so the decode steps wrap danube's 32-slot ring and gemma2's local layers
mask; the SSM prefill of 8 tokens is half of one 16-token chunk, so the
decode steps carry a state the chunked form left.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.models import transformer as jT
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as tT

from test_torch_lm import (BF16_HIDDEN_TOL, F32_HIDDEN_TOL, FAMILIES,
                           _cfgs, _frames, _weights)
import _torch_parity  # noqa: F401  (pins torch to one thread)

SERVED = ("h2o_danube_1p8b", "qwen2p5_3b", "qwen1p5_110b", "gemma2_27b",
          "chameleon_34b", "mixtral_8x22b", "olmoe_1b_7b")
ALL = SERVED + FAMILIES
B, L, LP, MAX_LEN = 2, 40, 8, 48

#: logits and K/V are held at the hidden-state tolerances of
#: ``test_torch_lm.py``: float32 5e-5 (the logits are the hidden states
#: times a 1e-2-scaled unembedding, the K/V their projections), bfloat16
#: 8 ulps at |h| ~ 4 (0.125)
TOL = {"float32": F32_HIDDEN_TOL, "bfloat16": BF16_HIDDEN_TOL}


def _tokens(vocab, n=L, seed=11):
    return np.random.default_rng(seed).integers(0, vocab, (B, n)).astype(
        np.int32)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if a.dtype != jnp.int32 else np.asarray(a), tree)


def _jax_step_fn(jcfg):
    """One teacher-forced decode step: forward with the cache + lm_head
    (what ``make_decode_step`` runs before its argmax)."""
    def step(params, cache, tok, pos):
        h, cache, _ = jT.forward(jcfg, params, tok[:, None], pos[None],
                                 caches=cache)
        return cache, jT.lm_head(jcfg, params, h)[:, 0]
    return jax.jit(step)


def _port_step(tcfg, model, cache, tok, pos):
    h, cache, _ = tT.forward(tcfg, model, tok[:, None],
                             torch.tensor([pos]), caches=cache)
    return cache, tT.lm_head(tcfg, model, h)[:, 0]


def _assert_cache_close(got, want, tol):
    """Every leaf of the cache tree (K/V rings, ``conv``, ``h``,
    ``enc_out``) within ``tol``, ``pos`` exact."""
    got = convert.cache_to_numpy(got)
    want = _np(want)

    def walk(g, w, path):
        assert set(g) == set(w), path
        for name in g:
            if isinstance(w[name], dict):
                walk(g[name], w[name], f"{path}/{name}")
                continue
            assert g[name].shape == w[name].shape, f"{path}/{name}"
            if name == "pos":
                np.testing.assert_array_equal(g[name], w[name])
            else:
                np.testing.assert_allclose(g[name], w[name], rtol=tol,
                                           atol=tol, err_msg=f"{path}/{name}")
    walk(got, want, "")


def _leaves(tree, path=""):
    for name, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{name}")
        else:
            yield f"{path}/{name}", v


def _fr(jcfg, b=B):
    """The same seeded frames for both packages (None for a decoder)."""
    f = _frames(jcfg, b=b)
    return (None, None) if f is None else (jnp.asarray(f),
                                           torch.as_tensor(f))


@pytest.mark.parametrize("max_len", [MAX_LEN, 20])
@pytest.mark.parametrize("name", SERVED)
def test_init_cache_matches_reference(name, max_len):
    jcfg, tcfg = _cfgs(name)
    want = jT.init_cache(jcfg, B, max_len)
    got = tT.init_cache(tcfg, B, max_len, device="cpu")
    assert set(got) == set(want) == {"k", "v", "pos"}
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
    assert got["k"].dtype == torch.bfloat16
    assert got["pos"].dtype == torch.int32
    assert bool((got["pos"] == -1).all()) and not got["k"].any()
    assert tT.cache_width(tcfg, max_len) == want["k"].shape[3]


@pytest.mark.parametrize("max_len", [MAX_LEN, 20])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_init_cache_matches_reference(name, max_len):
    """The SSM state, the hybrid's per-group rings and stacked Mamba2
    states, and Whisper's self-attention rings and encoder output: the
    reference's tree, shapes and dtypes (the state ``h`` float32), empty."""
    jcfg, tcfg = _cfgs(name)
    want = dict(_leaves(jT.init_cache(jcfg, B, max_len)))
    got = dict(_leaves(tT.init_cache(tcfg, B, max_len, device="cpu")))
    assert set(got) == set(want)
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shape, path
        assert str(t.dtype).split(".")[-1] == str(want[path].dtype), path
        if path.endswith("pos"):
            assert bool((t == -1).all())
        else:
            assert not t.any()


PREFILL_CASES = ([(n, dt) for n in SERVED for dt in ("float32", "bfloat16")]
                 + [(n, dt) for n in FAMILIES
                    for dt in ("float32", "bfloat16")
                    if (n, dt) != ("zamba2_7b", "bfloat16")])


@pytest.mark.parametrize("name,dt", PREFILL_CASES)
def test_prefill_and_decode_match_jax(name, dt):
    """Prefill logits, every teacher-forced decode step's logits, and the
    final cache, each package from its own empty cache.  (Zamba2 in
    bfloat16 is held by ``test_torch_lm.py`` against the reference's own
    bfloat16 error instead: see HYBRID_BF16_RATIO there.)"""
    jcfg, tcfg = _cfgs(name, dtype=dt)
    params = _weights(jcfg)
    toks = _tokens(jcfg.vocab)
    tol = TOL[dt]
    jfr, tfr = _fr(jcfg)

    jcache = jT.init_cache(jcfg, B, MAX_LEN)
    jcache, jlogits = jax.jit(jlm.make_prefill(jcfg, MAX_LEN))(
        params, jcache, jnp.asarray(toks[:, :LP]), jfr)
    model = convert.lm_params_from_numpy(tcfg, params, device="cpu")
    tcache = tT.init_cache(tcfg, B, MAX_LEN, device="cpu")
    tcache, tlogits = tlm.make_prefill(tcfg, MAX_LEN)(
        model, tcache, torch.as_tensor(toks[:, :LP]), tfr)
    assert tuple(tlogits.shape) == (B, jcfg.vocab_pad)
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=tol, atol=tol)
    _assert_cache_close(tcache, jcache, tol)

    jstep = _jax_step_fn(jcfg)
    for t in range(LP, L):
        jcache, jl = jstep(params, jcache, jnp.asarray(toks[:, t]),
                           jnp.asarray(t, jnp.int32))
        tcache, tl = _port_step(tcfg, model, tcache,
                                torch.as_tensor(toks[:, t]), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                   atol=tol, err_msg=f"decode step {t}")
    _assert_cache_close(tcache, jcache, tol)


@pytest.mark.parametrize("name", ALL)
def test_greedy_decode_from_a_carried_cache_matches_jax(name):
    """The reference's prefilled cache, carried into the port with
    ``cache_from_numpy``: ``make_decode_step`` in both packages, float32,
    picks the same greedy token at every step and leaves the same cache
    (Whisper's decode steps read the carried encoder output)."""
    jcfg, tcfg = _cfgs(name, dtype="float32")
    params = _weights(jcfg, seed=1)
    toks = _tokens(jcfg.vocab, seed=12)
    jcache, jlogits = jax.jit(jlm.make_prefill(jcfg, MAX_LEN))(
        params, jT.init_cache(jcfg, B, MAX_LEN), jnp.asarray(toks[:, :LP]),
        _fr(jcfg)[0])
    tcache = convert.cache_from_numpy(tcfg, _np(jcache), device="cpu")
    model = convert.lm_params_from_numpy(tcfg, params, device="cpu")
    jdecode = jax.jit(jlm.make_decode_step(jcfg))
    tdecode = tlm.make_decode_step(tcfg)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    ttok = torch.as_tensor(np.array(jtok))
    for t in range(LP, L):
        jcache, jtok = jdecode(params, jcache, jtok, jnp.asarray(t))
        tcache, ttok = tdecode(model, tcache, ttok,
                               torch.tensor(t).reshape(1))
        assert ttok.dtype == torch.int32
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok),
                                      err_msg=f"step {t}")
    _assert_cache_close(tcache, jcache, F32_HIDDEN_TOL)


@pytest.mark.parametrize("name", ALL)
def test_decode_matches_full_forward(name):
    """The port's counterpart of ``test_models.py``'s (which leaves
    Whisper out; here it decodes from the frames the full forward
    encodes): teacher-forced decode through the cache reproduces the
    port's own cache-free forward at the prefill's last position and at
    the final one, float32, argmax included.  The SSM families hold the
    same 2e-3: the chunked and recurrent orders agree to ~1e-6 here."""
    jcfg, tcfg = _cfgs(name, dtype="float32")
    model = tT.init_params(tcfg, seed=2, max_len=MAX_LEN, device="cpu")
    toks = torch.as_tensor(_tokens(tcfg.vocab, n=24, seed=13))
    n = toks.shape[1]
    fr = _fr(jcfg)[1]
    h, _, _ = tT.forward(tcfg, model, toks, torch.arange(n), enc_frames=fr)
    full = tT.lm_head(tcfg, model, h)
    cache = tT.init_cache(tcfg, B, MAX_LEN, device="cpu")
    cache, logits = tlm.make_prefill(tcfg, MAX_LEN)(model, cache,
                                                    toks[:, :LP], fr)
    torch.testing.assert_close(logits, full[:, LP - 1], rtol=2e-3,
                               atol=2e-3)
    decode = tlm.make_decode_step(tcfg)
    for t in range(LP, n - 1):
        cache, _ = decode(model, cache, toks[:, t], t)
    cache, step_logits = _port_step(tcfg, model, cache, toks[:, n - 1],
                                    n - 1)
    torch.testing.assert_close(step_logits, full[:, n - 1], rtol=2e-3,
                               atol=2e-3)
    assert torch.equal(step_logits.argmax(-1), full[:, n - 1].argmax(-1))


def test_swa_ring_cache_correct():
    """The port's counterpart of ``test_models.py``'s: a 47-token prompt
    prefilled single-shot into a 16-slot ring (longer than the ring), then
    a decode step at position 47, against the cache-free forward; and the
    ring it leaves is the reference's, slot by slot."""
    jcfg, tcfg = _cfgs("h2o_danube_1p8b", dtype="float32", window=16)
    params = _weights(jcfg, seed=3)
    toks = np.random.default_rng(14).integers(0, jcfg.vocab, (1, 48)).astype(
        np.int32)
    model = convert.lm_params_from_numpy(tcfg, params, device="cpu")
    h, _, _ = tT.forward(tcfg, model, torch.as_tensor(toks),
                         torch.arange(48))
    full = tT.lm_head(tcfg, model, h)
    cache = tT.init_cache(tcfg, 1, 64, device="cpu")
    assert cache["k"].shape[3] == tcfg.window        # ring is window-sized
    cache, _ = tlm.make_prefill(tcfg, 64)(model, cache,
                                          torch.as_tensor(toks[:, :47]))
    jcache, _ = jax.jit(jlm.make_prefill(jcfg, 64))(
        params, jT.init_cache(jcfg, 1, 64), jnp.asarray(toks[:, :47]))
    # slot s holds position 31 + ((s - 31) mod 16): the last 16 written
    np.testing.assert_array_equal(
        cache["pos"][0].numpy(), 31 + (np.arange(16) - 31) % 16)
    _assert_cache_close(cache, jcache, F32_HIDDEN_TOL)
    cache, step_logits = _port_step(tcfg, model, cache,
                                    torch.as_tensor(toks[:, 47]), 47)
    torch.testing.assert_close(step_logits, full[:, 47], rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("name", ALL)
def test_chunked_prefill_matches_jax(name):
    """``prefill_chunk=8`` at L = 24: three segments, each against the
    whole updated ring (``fresh_kv=False``) and from the Mamba2 state the
    last one left, float32, against the reference's chunked prefill and
    against the port's single-shot prefill.  Whisper's prompt is never
    chunked: one single-shot pass in both packages."""
    jcfg, tcfg = _cfgs(name, dtype="float32", prefill_chunk=8)
    params = _weights(jcfg, seed=4)
    toks = _tokens(jcfg.vocab, n=24, seed=15)
    jfr, tfr = _fr(jcfg)
    jcache, jlogits = jax.jit(jlm.make_prefill(jcfg, MAX_LEN))(
        params, jT.init_cache(jcfg, B, MAX_LEN), jnp.asarray(toks), jfr)
    model = convert.lm_params_from_numpy(tcfg, params, device="cpu")
    tcache, tlogits = tlm.make_prefill(tcfg, MAX_LEN)(
        model, tT.init_cache(tcfg, B, MAX_LEN, device="cpu"),
        torch.as_tensor(toks), tfr)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=F32_HIDDEN_TOL, atol=F32_HIDDEN_TOL)
    _assert_cache_close(tcache, jcache, F32_HIDDEN_TOL)
    one = tcfg.with_(prefill_chunk=0)
    _, whole = tlm.make_prefill(one, MAX_LEN)(
        model, tT.init_cache(one, B, MAX_LEN, device="cpu"),
        torch.as_tensor(toks), tfr)
    torch.testing.assert_close(tlogits, whole, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", ALL)
def test_serve_batch_matches_jax(name):
    """``serve_batch`` in both packages on the same weights and prompts
    (and Whisper's seeded frames), float32: the same (B, gen) greedy
    tokens."""
    jcfg, tcfg = _cfgs(name, dtype="float32")
    params = _weights(jcfg, seed=5)
    prompts = _tokens(jcfg.vocab, n=12, seed=16)
    jfr, tfr = _fr(jcfg)
    want = np.asarray(jserve.serve_batch(jcfg, params, jnp.asarray(prompts),
                                         10, 24, frames=jfr))
    model = convert.lm_params_from_numpy(tcfg, params, device="cpu")
    stats = {}
    got = tserve.serve_batch(tcfg, model, torch.as_tensor(prompts), 10, 24,
                             frames=tfr, stats=stats)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["prefill_s"] > 0 and len(stats["step_s"]) == 9
    assert all(s > 0 for s in stats["step_s"])
    assert torch.equal(stats["logits"].argmax(-1).int(), got[:, 0])
    # the rings hold the prompt and every fed-back token: positions 0..20
    rings = dict(_leaves(stats["cache"]))
    for path, t in rings.items():
        if path.endswith("pos"):
            assert t.max() == 12 + 10 - 2, path
    # the master weights are not touched by the cast
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_cache_numpy_round_trip():
    _family_cache_round_trip("qwen2p5_3b")


@pytest.mark.parametrize("name", FAMILIES)
def test_family_cache_numpy_round_trip(name):
    """The nested trees: ``conv`` in bf16, ``h`` in f32, the hybrid's
    ``shared`` / ``mamba`` groups, Whisper's ``layers.self`` and
    ``enc_out``."""
    _family_cache_round_trip(name)


def _family_cache_round_trip(name):
    _, tcfg = _cfgs(name)
    cache = tT.init_cache(tcfg, B, 16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for path, t in _leaves(cache):
        if path.endswith("pos"):
            t[..., :5] = torch.arange(5, dtype=torch.int32)
        else:
            t.copy_(torch.randn(t.shape, generator=gen))
    back = convert.cache_from_numpy(tcfg, convert.cache_to_numpy(cache),
                                    device="cpu")
    got, want = dict(_leaves(back)), dict(_leaves(cache))
    assert set(got) == set(want)
    for path, t in want.items():
        assert got[path].dtype == t.dtype, path
        assert torch.equal(got[path], t), path
