"""LM-zoo building blocks: norms, RoPE, GQA attention (causal / sliding
window / softcap / qk-norm) and SwiGLU & GELU MLPs.

Port of ``repro.models.layers``, cache-free paths only.  Parameters come
from *schemas* as in the reference: each entry is ``name -> (shape,
logical_axes, init_scale)``, so the parameter tree and its initializer
never drift apart.  A layer reads its parameters from any mapping ``p``
(a dict, or a :class:`~repro_torch.models.transformer.ParamBlock`).

The reference's numerics are kept: norms and RoPE in float32 and cast
back to the compute dtype, rmsnorm's ``1 + scale``, RoPE on halves (not
interleaved), attention logits in float32 and the ``-1e30`` mask
sentinel.  Attention with a serve cache and MoE belong to later slices
and raise ``NotImplementedError``; cross-attention comes with Whisper's
slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .config import ModelConfig

NEG_INF = -1e30

SERVE_SLICE = ("the serving slice (prefill/decode with caches, "
               "lm.make_prefill / make_decode_step)")

# ---------------------------------------------------------------------------
# schema machinery
# ---------------------------------------------------------------------------


def build_params(schema: dict, gen: torch.Generator, dtype: torch.dtype,
                 device: torch.device) -> dict:
    """Tensors for ``schema``, drawn from ``gen`` in sorted-name order:
    zeros for scale 0, ones for a vector of scale 1, else N(0, scale^2).
    ``gen`` lives on ``device``.  The draws are not the reference's (a
    ``jax.random`` key gives other numbers); tests carry the reference's
    weights over with ``convert.lm_params_from_numpy``."""
    out = {}
    for name in sorted(schema):
        shape, _, scale = schema[name]
        if scale == 0.0:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif scale == 1.0 and len(shape) <= 1:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            t = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device)
            out[name] = t.mul_(scale).to(dtype)
    return out


def stack_schema(schema: dict, n: int):
    """Add a leading `layers` dimension to every entry (the reference's
    scanned stack; the port keeps one block per layer)."""
    return {name: ((n,) + tuple(shape), ("layers",) + tuple(lg), scale)
            for name, (shape, lg, scale) in schema.items()}


def fan_in(*dims):
    return 1.0 / math.sqrt(dims[0])


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def layernorm(x, scale, bias, eps):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * scale + bias
    return y.to(dt)


def norm_schema(cfg: ModelConfig, prefix: str):
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {f"{prefix}_scale": ((d,), ("none",), 1.0),
                f"{prefix}_bias": ((d,), ("none",), 0.0)}
    return {f"{prefix}_scale": ((d,), ("none",), 0.0)}  # rms: 1 + scale


def apply_norm(cfg: ModelConfig, p, prefix: str, x):
    if cfg.norm == "layernorm":
        return layernorm(x, p[f"{prefix}_scale"], p[f"{prefix}_bias"],
                         cfg.norm_eps)
    return rmsnorm(x, p[f"{prefix}_scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x, positions, theta):
    """x: (..., L, H, hd); positions: (..., L)."""
    hd = x.shape[-1]
    half = hd // 2
    # a Python base: no host-to-device copy (which would block the host)
    freq = float(theta) ** (-torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half)
    ang = positions.float()[..., None, None] * freq       # (L, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    dt = x.dtype
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(dt)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_schema(cfg: ModelConfig, prefix: str = "attn"):
    d, hd, Hq, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv
    s = {
        f"{prefix}_wq": ((d, Hq * hd), ("embed", "q_heads"), fan_in(d)),
        f"{prefix}_wk": ((d, Hkv * hd), ("embed", "kv"), fan_in(d)),
        f"{prefix}_wv": ((d, Hkv * hd), ("embed", "kv"), fan_in(d)),
        f"{prefix}_wo": ((Hq * hd, d), ("q_heads", "embed"), fan_in(Hq * hd)),
    }
    if cfg.qkv_bias:
        s[f"{prefix}_bq"] = ((Hq * hd,), ("q_heads",), 0.0)
        s[f"{prefix}_bk"] = ((Hkv * hd,), ("kv",), 0.0)
        s[f"{prefix}_bv"] = ((Hkv * hd,), ("kv",), 0.0)
    if cfg.family == "vlm":                  # chameleon's qk-norm
        s[f"{prefix}_qnorm"] = ((hd,), ("none",), 0.0)
        s[f"{prefix}_knorm"] = ((hd,), ("none",), 0.0)
    return s


def _attn_mask(qpos, kpos, *, causal, window):
    """(Lq, Lk) keep-mask; window 0/None means no window."""
    mask = (kpos >= 0)[None, :].expand(qpos.shape[0], -1)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None and int(window) > 0:
        mask = mask & (kpos[None, :] > qpos[:, None] - int(window))
    return mask


def _softcap(s, softcap):
    return s if softcap is None else softcap * torch.tanh(s / softcap)


def mea_attention(q, k, v, qpos, kpos, window, causal, scale, softcap,
                  chunk):
    """Forward of the reference's memory-efficient attention: an online
    softmax over kv chunks of ``chunk`` keys, all in float32.

    q: (B, H, Lq, D); k, v: (B, H, Lk, D); qpos: (Lq,); kpos: (Lk,).
    ``window`` <= 0 means no window.  Returns (B, H, Lq, D) in q's dtype.
    """
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    nc = max(1, Lk // chunk)
    ck = Lk // nc
    qf = q.float()
    m = torch.full((B, H, Lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=q.device)
    for c in range(nc):
        kc = k[:, :, c * ck:(c + 1) * ck].float()
        vc = v[:, :, c * ck:(c + 1) * ck].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kc) * scale
        s = _softcap(s, softcap)
        keep = _attn_mask(qpos, kpos[c * ck:(c + 1) * ck], causal=causal,
                          window=window)
        s = torch.where(keep[None, None], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vc)
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return (acc / l[..., None]).to(q.dtype)


def _pick_chunk(lk: int, target: int) -> int:
    """Largest divisor of lk that is <= target."""
    c = min(target, lk)
    while lk % c:
        c -= 1
    return max(c, 1)


def _project_qkv(cfg: ModelConfig, p, x, prefix: str):
    """(B, L, H, hd) projections with the optional qkv bias."""
    B, L, _ = x.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv
    dt = x.dtype
    q = x @ p[f"{prefix}_wq"].to(dt)
    k = x @ p[f"{prefix}_wk"].to(dt)
    v = x @ p[f"{prefix}_wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p[f"{prefix}_bq"].to(dt)
        k = k + p[f"{prefix}_bk"].to(dt)
        v = v + p[f"{prefix}_bv"].to(dt)
    return (q.reshape(B, L, Hq, hd), k.reshape(B, L, Hkv, hd),
            v.reshape(B, L, Hkv, hd))


def attention(cfg: ModelConfig, p, x, positions, *, prefix="attn",
              causal=True, window=None, cache=None):
    """GQA self-attention without a cache.  x: (B, L, d); positions:
    (L,) absolute positions.  Returns (out, None).

    ``cfg.attention_impl`` "chunked" runs the reference's memory-
    efficient online softmax (:func:`mea_attention`); any other value
    runs the materialized einsum path ("ref").  A ``cache`` (the serve
    path) raises ``NotImplementedError``; so does Whisper's
    cross-attention, whose family the model refuses."""
    if cache is not None:
        raise NotImplementedError(
            f"attention with a KV cache belongs to {SERVE_SLICE}")
    B, L, d = x.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv
    dt = x.dtype
    q, k, v = _project_qkv(cfg, p, x, prefix)
    if f"{prefix}_qnorm" in p:
        q = rmsnorm(q, p[f"{prefix}_qnorm"], cfg.norm_eps)
        k = rmsnorm(k, p[f"{prefix}_knorm"], cfg.norm_eps)
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = q.transpose(1, 2)                             # (B, Hq, L, hd)
    k = k.transpose(1, 2)                             # (B, Hkv, L, hd)
    v = v.transpose(1, 2)

    scale = hd ** -0.5
    group = Hq // Hkv
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=1)
        v = torch.repeat_interleave(v, group, dim=1)
    qpos = kpos = positions

    if cfg.attention_impl == "chunked":
        chunk = _pick_chunk(L, cfg.attn_chunk)
        out = mea_attention(q, k, v, qpos, kpos,
                            0 if window is None else int(window), causal,
                            scale, cfg.softcap, chunk)
    else:
        # float32 logits of the compute-dtype operands (the reference's
        # preferred_element_type=float32), masked in place
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits.mul_(scale)
        logits = _softcap(logits, cfg.softcap)
        keep = _attn_mask(qpos, kpos, causal=causal, window=window)
        logits.masked_fill_(~keep[None, None], NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(dt)
        del logits
        out = torch.matmul(probs, v)
    out = out.to(dt).transpose(1, 2).reshape(B, L, -1)
    return out @ p[f"{prefix}_wo"].to(dt), None


def attention_flash(cfg: ModelConfig, p, x, positions, *, prefix="attn",
                    causal=True, window=None):
    """Self-attention through the flash-attention kernel (static window
    only).  As in the reference, this path applies no qk-norm.

    The kernel reads q, k and v as the (B, H, L, hd) transposed views of
    the (B, L, H, hd) projections, by strides, and writes its output in
    the same layout, so neither side copies."""
    B, L, _ = x.shape
    dt = x.dtype
    q, k, v = _project_qkv(cfg, p, x, prefix)
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = kops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=int(window) if window else None,
        softcap=cfg.softcap)
    out = out.transpose(1, 2).reshape(B, L, -1)
    return out @ p[f"{prefix}_wo"].to(dt), None


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_schema(cfg: ModelConfig, prefix: str = "mlp", d_ff: int | None = None):
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    if cfg.mlp == "swiglu":
        return {
            f"{prefix}_wg": ((d, f), ("embed", "mlp"), fan_in(d)),
            f"{prefix}_wu": ((d, f), ("embed", "mlp"), fan_in(d)),
            f"{prefix}_wd": ((f, d), ("mlp", "embed"), fan_in(f)),
        }
    return {
        f"{prefix}_wu": ((d, f), ("embed", "mlp"), fan_in(d)),
        f"{prefix}_bu": ((f,), ("mlp",), 0.0),
        f"{prefix}_wd": ((f, d), ("mlp", "embed"), fan_in(f)),
        f"{prefix}_bd": ((d,), ("none",), 0.0),
    }


def apply_mlp(cfg: ModelConfig, p, x, prefix: str = "mlp"):
    dt = x.dtype
    if cfg.mlp == "swiglu":
        g = F.silu(x @ p[f"{prefix}_wg"].to(dt))
        u = x @ p[f"{prefix}_wu"].to(dt)
        return (g * u) @ p[f"{prefix}_wd"].to(dt)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p[f"{prefix}_wu"].to(dt) + p[f"{prefix}_bu"].to(dt),
               approximate="tanh")
    return h @ p[f"{prefix}_wd"].to(dt) + p[f"{prefix}_bd"].to(dt)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_SLICE = "the MoE slice (apply_moe, expert dispatch)"


def moe_schema(cfg: ModelConfig, prefix: str = "moe"):
    raise NotImplementedError(f"{cfg.name}: MoE layers belong to {MOE_SLICE}")


def apply_moe(cfg: ModelConfig, p, x, prefix: str = "moe"):
    raise NotImplementedError(f"{cfg.name}: MoE layers belong to {MOE_SLICE}")
