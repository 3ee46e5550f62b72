"""The MoE layer, port against the JAX reference, on the CPU at smoke
sizes: the schema and capacity, ``positions_in_expert``, the router's
top-k and its ties, the dispatch (``keep`` and ``slot`` exact under
forced drops) and ``apply_moe`` on all three ``expert_sharding`` modes,
the virtual f-slice split, and ``lm.loss_fn`` of the MoE decoders with
its load-balance term."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as tT

from test_torch_lm import (BF16_HIDDEN_TOL, F32_HIDDEN_TOL, F32_LOSS_TOL,
                           _cfgs, _weights)
import _torch_parity  # noqa: F401  (pins torch to one thread)

MOE = ("mixtral_8x22b", "olmoe_1b_7b")
MODES = ("ep", "tp", "ep_virtual")


def _moe_params(jcfg, seed):
    """The reference's MoE weights for ``jcfg``, as numpy and as port
    tensors."""
    p = jax.tree.map(np.asarray, jL.build_params(
        jL.moe_schema(jcfg), jax.random.PRNGKey(seed), jnp.float32))
    return p, {k: torch.tensor(v) for k, v in p.items()}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", MOE)
def test_moe_schema_matches_reference(name, mode):
    jcfg, tcfg = _cfgs(name, expert_sharding=mode)
    assert tL.moe_schema(tcfg) == jL.moe_schema(jcfg)
    assert (tcfg.n_experts_disp, tcfg.d_ff_expert_disp) == (
        jcfg.n_experts_disp, jcfg.d_ff_expert_disp)
    assert tT.model_schema(tcfg) == jT.model_schema(jcfg)


@pytest.mark.parametrize("n_tokens", [1, 8, 127, 512, 4095, 4096, 32768,
                                      65536])
@pytest.mark.parametrize("name", MOE)
def test_moe_capacity_matches_reference(name, n_tokens):
    for get in ("get", "get_smoke"):
        jcfg = getattr(jconfigs, get)(name)
        tcfg = getattr(tconfigs, get)(name)
        assert tL.moe_capacity(tcfg, n_tokens) == jL.moe_capacity(
            jcfg, n_tokens)


@pytest.mark.parametrize("n, n_experts", [(1, 4), (1500, 9), (4096, 64),
                                          (3000, 16)])
def test_positions_in_expert_matches_reference_and_naive(n, n_experts):
    ids = np.random.default_rng(n).integers(0, n_experts, n).astype(np.int32)
    got = tL.positions_in_expert(torch.as_tensor(ids), n_experts).numpy()
    for block in (128, 256):
        want = np.asarray(jL.positions_in_expert(jnp.asarray(ids), n_experts,
                                                 block=block))
        np.testing.assert_array_equal(got, want)
    cnt = np.zeros(n_experts, np.int64)
    for i, e in enumerate(ids):
        assert got[i] == cnt[e]
        cnt[e] += 1


def test_virtual_expert_split_is_exact():
    """The port's counterpart of ``test_models.py``'s: splitting each
    expert's d_ff into 2 virtual experts is an exact decomposition of the
    expert MLP (capacity large enough that nothing drops)."""
    _, base = _cfgs("mixtral_8x22b", dtype="float32", expert_sharding="ep",
                    capacity_factor=8.0)
    virt = base.with_(expert_sharding="ep_virtual", virtual_split=2)
    E, d, f = base.n_experts, base.d_model, base.d_ff_expert
    gen = torch.Generator().manual_seed(7)
    p_base = tL.build_params(tL.moe_schema(base), gen, torch.float32,
                             torch.device("cpu"))

    def split_up(w):    # (E, d, f) -> (2E, d, f/2)
        return w.reshape(E, d, 2, f // 2).permute(0, 2, 1, 3).reshape(
            2 * E, d, f // 2)

    def split_down(w):  # (E, f, d) -> (2E, f/2, d)
        return w.reshape(2 * E, f // 2, d)

    p_virt = {"moe_router": p_base["moe_router"],
              "moe_wg": split_up(p_base["moe_wg"]),
              "moe_wu": split_up(p_base["moe_wu"]),
              "moe_wd": split_down(p_base["moe_wd"])}
    x = torch.randn((2, 16, d), generator=gen) * 0.3
    y_base, aux_base = tL.apply_moe(base, p_base, x)
    y_virt, aux_virt = tL.apply_moe(virt, p_virt, x)
    torch.testing.assert_close(y_virt, y_base, rtol=1e-4, atol=1e-5)
    assert float(aux_virt) == float(aux_base)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", MOE)
def test_dispatch_and_apply_moe_match_jax(name, mode, dt):
    """512 tokens at ``capacity_factor`` 0.25: the capacity is the
    128-slot floor while each expert gets ~128-256 assignments, so the
    dispatch drops.  On the same input, ``keep`` and ``slot`` equal the
    reference's exactly, the buffer too (copies of the input), the gates
    and load-balance sums to float32 rounding, and ``apply_moe``'s output
    and aux loss to ``test_torch_lm.py``'s hidden-state tolerance."""
    jcfg, tcfg = _cfgs(name, dtype=dt, expert_sharding=mode,
                       capacity_factor=0.25)
    jp, tp = _moe_params(jcfg, seed=3)
    x = (np.random.default_rng(4).standard_normal((2, 256, jcfg.d_model))
         * 0.5).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.dtype(dt)), torch.as_tensor(x).to(
        getattr(torch, dt))
    T = 512
    C = tL.moe_capacity(tcfg, T)
    assert C == 128
    want = jL._moe_dispatch_local(jcfg, jx.reshape(T, -1),
                                  jnp.asarray(jp["moe_router"]), C, 0, 1, T)
    got = tL._moe_dispatch_local(tcfg, tx.reshape(T, -1), tp["moe_router"],
                                 C)
    (wbuf, wslot, wgates, wkeep, (wme, wce)) = jax.tree.map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.asarray(a), want)
    (gbuf, gslot, ggates, gkeep, (gme, gce)) = got
    assert 0 < int((~gkeep).sum()) < gkeep.numel()       # it did drop
    np.testing.assert_array_equal(gkeep.numpy(), wkeep)
    np.testing.assert_array_equal(gslot.numpy(), wslot)
    np.testing.assert_array_equal(gbuf.float().numpy(), wbuf)
    np.testing.assert_allclose(ggates.numpy(), wgates, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gme.numpy(), wme, rtol=1e-5)
    np.testing.assert_array_equal(gce.numpy(), wce)

    wout, waux = jL.apply_moe(jcfg, jp, jx)
    with tL.count_moe_drops() as tally:
        gout, gaux = tL.apply_moe(tcfg, tp, tx)
    assert tally.dropped == int((~gkeep).sum())
    assert tally.assigned == gkeep.numel()
    tol = F32_HIDDEN_TOL if dt == "float32" else BF16_HIDDEN_TOL
    np.testing.assert_allclose(gout.float().numpy(),
                               np.asarray(wout, np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-6)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_router_ties_break_to_the_lower_index(dt):
    """Small-integer tokens and router weights make every logit an exact
    integer, so most rows tie at the top-k boundary; the port picks the
    reference's experts (``lax.top_k``: lower index first) in the same
    order, and the dispatch that follows is the same."""
    jcfg, tcfg = _cfgs("olmoe_1b_7b", dtype=dt, n_experts=16, top_k=4)
    rng = np.random.default_rng(5)
    x = rng.integers(-2, 3, (96, jcfg.d_model)).astype(np.float32)
    router = rng.integers(-1, 2, (jcfg.d_model, 16)).astype(np.float32)
    logits = x @ router
    top = np.sort(logits, axis=1)[:, ::-1]
    assert (top[:, 3] == top[:, 4]).mean() > 0.1            # ties bite
    want = jax.lax.top_k(jnp.asarray(logits), 4)[1]
    _, ids = tL.router_top_k(torch.as_tensor(logits), 4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ids.numpy(), np.argsort(-logits, axis=1, kind="stable")[:, :4])
    jdt = jnp.dtype(dt)
    wslot = jL._moe_dispatch_local(
        jcfg, jnp.asarray(x, jdt), jnp.asarray(router), 128, 0, 1, 96)[1]
    gslot = tL._moe_dispatch_local(
        tcfg, torch.as_tensor(x).to(getattr(torch, dt)),
        torch.as_tensor(router), 128)[1]
    np.testing.assert_array_equal(gslot.numpy(), np.asarray(wslot))


@pytest.mark.parametrize("impl", ["flash", "ref", "chunked"])
@pytest.mark.parametrize("name", MOE)
def test_moe_loss_fn_matches_jax(name, impl):
    """``lm.loss_fn`` of the MoE decoders: ``total = loss + 0.01 * aux``
    with the load-balance aux summed over the layers, and the final
    hidden states, at ``test_torch_lm.py``'s float32 tolerances.

    Float32 only: in bfloat16 the two libraries' hidden states differ by
    a few ulps, and a token whose k-th and (k+1)-th router logits lie
    closer than that takes another expert in one package than in the
    other (on these inputs, 4 of olmoe's 128 tokens in layer 2, at gaps
    of 0 to 2^-6; one of mixtral's, whose change attention then carries
    to the later tokens).  ``test_dispatch_and_apply_moe_match_jax``
    holds the bfloat16 layer on one shared input instead."""
    jcfg, tcfg = _cfgs(name, attention_impl=impl, dtype="float32")
    params = _weights(jcfg)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 65))
    tokens, targets = toks[:, :-1], toks[:, 1:]

    def run(p, t, y):
        total, aux = jlm.loss_fn(jcfg, p, jlm.Batch(tokens=t, targets=y))
        h = jT.forward(jcfg, jlm.cast_params(jcfg, p), t, jnp.arange(64))[0]
        return total, aux["loss"], aux["aux_loss"], h.astype(jnp.float32)
    wtotal, wloss, waux, wh = jax.jit(run)(
        params, jnp.asarray(tokens, jnp.int32),
        jnp.asarray(targets, jnp.int32))

    model = convert.lm_params_from_numpy(tcfg, params, device="cpu")
    tok, tgt = torch.as_tensor(tokens), torch.as_tensor(targets)
    total, aux = tlm.loss_fn(tcfg, model, tlm.Batch(tokens=tok, targets=tgt))
    h = tT.forward(tcfg, tlm.cast_params(tcfg, model), tok,
                   torch.arange(64))[0]
    loss_tol, h_tol = F32_LOSS_TOL, F32_HIDDEN_TOL
    assert float(aux["aux_loss"]) > 1.0     # two layers, each >= 1-ish
    assert float(total) == pytest.approx(
        float(aux["loss"]) + 0.01 * float(aux["aux_loss"]), abs=1e-6)
    assert abs(float(aux["aux_loss"]) - float(waux)) <= 10 * loss_tol
    assert abs(float(aux["loss"]) - float(wloss)) <= loss_tol
    assert abs(float(total) - float(wtotal)) <= loss_tol
    np.testing.assert_allclose(h.float().numpy(), np.asarray(wh),
                               rtol=h_tol, atol=h_tol)


def test_drops_are_counted_only_inside_a_block():
    _, tcfg = _cfgs("olmoe_1b_7b", dtype="float32", capacity_factor=0.25)
    _, tp = _moe_params(_cfgs("olmoe_1b_7b")[0], seed=6)
    x = torch.randn((4, 128, tcfg.d_model),
                    generator=torch.Generator().manual_seed(8))
    tL.apply_moe(tcfg, tp, x)
    assert tL._DROP_TALLY is None
    with tL.count_moe_drops() as tally:
        tL.apply_moe(tcfg, tp, x)
        tL.apply_moe(tcfg, tp, x[:1])
        assert tally.dropped == 0                  # read when the block ends
    assert tally.assigned == 5 * 128 * tcfg.top_k
    assert tally.dropped > 0
    assert tL._DROP_TALLY is None
