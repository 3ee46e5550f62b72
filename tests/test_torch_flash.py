"""The flash-attention kernel's plain versions on the CPU, against the
JAX reference: the port's ``ref.attention`` against the reference's
oracle ``repro.kernels.ref.attention``, and the kernel's plain version
(``ops.flash_attention`` on CPU tensors) against the Pallas kernel in
interpret mode, run alone, at every manifest config and at a danube-like
GQA + sliding-window shape.  The CUDA kernel is held against the plain
version on the card in ``test_torch_kernels_gpu.py``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import manifest as tman
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

import _torch_parity  # noqa: F401  (pins torch to one thread)

FLASH = tman.entry("flash_attention")

#: h2o-danube's attention pattern cut down: GQA 2:1, causal, a window
#: shorter than the sequence (so whole tiles fall outside it)
DANUBE_LIKE = {"label": "danube-like-gqa-window", "B": 2, "Hq": 4, "Hkv": 2,
               "Lq": 64, "Lkv": 64, "D": 16, "block_q": 16, "block_k": 16,
               "causal": True, "window": 32}

CONFIGS = (*FLASH["configs"], DANUBE_LIKE)

#: f32 oracle against oracle: both materialize the softmax in float32;
#: the two libraries' exp and summation order differ by a few ulps
ORACLE_TOL = 1e-5
#: the manifest's fp-tolerant class (online vs materialized softmax)
KERNEL_TOL = FLASH["rtol"]


def _problem(cfg, dtype=np.float32):
    rng = np.random.default_rng(len(cfg["label"]))
    q, k, v, kw = tman.flash_problem(cfg, rng)
    return q.astype(dtype), k.astype(dtype), v.astype(dtype), kw


def _t(*arrays, dtype=torch.float32):
    return [torch.as_tensor(a, dtype=dtype) for a in arrays]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["label"])
def test_plain_attention_matches_jax_oracle(cfg):
    q, k, v, kw = _problem(cfg)
    want = np.asarray(jref.attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **kw))
    got = tref.attention(*_t(q, k, v), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=ORACLE_TOL,
                               atol=ORACLE_TOL)
    # the kernel's plain version is the oracle at the kernel's scale
    plain = tops.flash_attention(*_t(q, k, v), **kw)
    np.testing.assert_allclose(plain.numpy(), want, rtol=ORACLE_TOL,
                               atol=ORACLE_TOL)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["label"])
def test_plain_flash_matches_pallas_kernel(cfg):
    """Same inputs through the Pallas kernel in interpret mode, alone (not
    under the sanitizer's harness), at the reference's block sizes."""
    q, k, v, kw = _problem(cfg)
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        block_q=cfg["block_q"], block_k=cfg["block_k"], interpret=True,
        **kw))
    got = tops.flash_attention(*_t(q, k, v), **kw)
    tol = KERNEL_TOL["float32"]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["label"])
def test_plain_flash_matches_pallas_kernel_bf16(cfg):
    """bfloat16 inputs: the Pallas kernel and the plain version both
    compute in float32 on the same bf16 values, then round to bf16; they
    may land a bf16 ulp apart (within the manifest's bf16 tolerance)."""
    q, k, v, kw = _problem(cfg)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jfa.flash_attention(
        *jb, block_q=cfg["block_q"], block_k=cfg["block_k"],
        interpret=True, **kw).astype(jnp.float32))
    got = tops.flash_attention(*_t(q, k, v, dtype=torch.bfloat16), **kw)
    assert got.dtype == torch.bfloat16
    tol = KERNEL_TOL["bfloat16"]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_plain_flash_takes_transposed_views():
    """``attention_flash`` hands over (B, H, L, D) views of (B, L, H, D)
    projections; the result equals the contiguous inputs' exactly."""
    q, k, v, kw = _problem(DANUBE_LIKE)
    qt, kt, vt = _t(q, k, v)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (qt, kt, vt)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(tops.flash_attention(*views, **kw),
                               tops.flash_attention(qt, kt, vt, **kw),
                               rtol=0, atol=0)


def test_cpu_flash_is_not_counted():
    tops.reset_launches()
    q, k, v, kw = _problem(FLASH["configs"][0])
    tops.flash_attention(*_t(q, k, v), **kw)
    assert tops.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("bad,err", [
    (dict(q=(1, 2, 48, 16), k=(1, 1, 40, 16)), "Lq <= Lkv"),
    (dict(q=(1, 3, 8, 16), k=(1, 2, 8, 16)), "divide"),
    (dict(q=(1, 2, 8, 16), k=(1, 1, 8, 8)), "must be"),
    (dict(q=(1, 2, 8, 16), k=(1, 1, 8, 16), window=0), "window"),
], ids=["lq-gt-lkv", "heads", "head-dim", "window-0"])
def test_flash_contract_raises_on_both_routes(bad, err):
    q = torch.zeros(bad["q"])
    k = torch.zeros(bad["k"])
    with pytest.raises(ValueError, match=err):
        tops.flash_attention(q, k, k, window=bad.get("window"))
    with pytest.raises(ValueError, match=err):
        tfa.validate(q, k, k, bad.get("window"))


def test_flash_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(TypeError, match="dtype"):
        tops.flash_attention(q, q.double(), q)


def test_aligned16_reads_pointer_and_strides():
    """The bf16 body's 16-byte loads need aligned row starts; the wrapper
    copies a tensor this test refuses.  Fresh allocations and the model's
    (B, H, L, D) views pass, a view one element in and a row stride that
    is not a multiple of 16 bytes do not."""
    t = torch.zeros((2, 4, 40, 80), dtype=torch.bfloat16)
    assert tfa.aligned16(t)
    assert tfa.aligned16(t.transpose(1, 2).contiguous().transpose(1, 2))
    assert not tfa.aligned16(torch.zeros(t.numel() + 1, dtype=t.dtype)[1:]
                             .view(t.shape))
    assert not tfa.aligned16(torch.zeros((2, 4, 40, 84),
                                         dtype=t.dtype)[..., :80])


def test_port_manifest_flash_entry_mirrors_jax():
    """The flash entry's configs are the reference's, its ``replaces``
    names the Pallas body, and nothing is left unported."""
    from repro.kernels import manifest
    jax_ent = next(e for e in manifest.KERNEL_ENTRIES
                   if e["name"] == FLASH["jax_entry"])
    assert FLASH["configs"] == jax_ent["configs"]
    assert FLASH["replaces"] == ("src/repro/kernels/flash_attention.py:34",)
    assert FLASH["rtol"]["float32"] == jax_ent["rtol"] == jax_ent["atol"]
    assert tman.NOT_PORTED == {}
