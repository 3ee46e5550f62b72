"""LM-zoo building blocks: norms, RoPE, GQA attention (causal / sliding
window / softcap / qk-norm, with or without a ring-buffered KV cache),
SwiGLU & GELU MLPs, and top-k MoE with capacity-bounded scatter dispatch.

Port of ``repro.models.layers``.  Parameters come from *schemas* as in
the reference: each entry is ``name -> (shape, logical_axes,
init_scale)``, so the parameter tree and its initializer never drift
apart.  A layer reads its parameters from any mapping ``p`` (a dict, or
a :class:`~repro_torch.models.transformer.ParamBlock`).

The reference's numerics are kept: norms and RoPE in float32 and cast
back to the compute dtype, rmsnorm's ``1 + scale``, RoPE on halves (not
interleaved), attention logits in float32 and the ``-1e30`` mask
sentinel.  The MoE dispatch is the reference's unsharded branch, or,
inside :func:`batch_shards` (a train step, prefill or decode on a
mesh), its per-data-shard branch: each shard of the batch dispatches its
own tokens into its own slice of the capacity.  Inside
``parallel.split_model`` (the "split" route on a mesh) the attention,
the MLP and the MoE compute this rank's share over the model team (see
each function), the cached attention on this rank's block of the ring.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from . import parallel as P
from .config import ModelConfig

NEG_INF = -1e30

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


def build_logical(schema: dict) -> dict:
    """Each entry's logical axis names."""
    return {name: tuple(spec[1]) for name, spec in schema.items()}


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


def _mea_forward(q, k, v, qpos, kpos, window, causal, scale, softcap,
                 chunk, *, with_lse: bool = False):
    """The online-softmax loop of :func:`mea_attention`; with
    ``with_lse`` also the (B, H, Lq) float32 log-sum-exp of each row's
    scaled, capped and masked logits."""
    m, l, acc = _mea_partial(q, k, v, qpos, kpos, window, causal, scale,
                             softcap, chunk)
    l = torch.clamp_min(l, 1e-30)
    out = (acc / l[..., None]).to(q.dtype)
    return (out, m + torch.log(l)) if with_lse else out


def _mea_partial(q, k, v, qpos, kpos, window, causal, scale, softcap,
                 chunk):
    """The online softmax over kv chunks of ``chunk`` keys, unnormalised:
    (m, l, acc), each row's running maximum (B, H, Lq), sum of
    exponentials and weighted values (B, H, Lq, D), float32.  A row whose
    keys are all masked has m = -1e30 and adds nothing once rescaled by
    exp(m - M) against a real maximum M."""
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
    return m, l, acc


def _mea_backward(q, k, v, qpos, kpos, out, lse, dout, window, causal,
                  scale, softcap, chunk):
    """The reference's ``_mea_vjp_bwd``: each kv chunk's probabilities
    recomputed from the saved log-sum-exp, ``delta = sum(dO * O)`` per
    row, the softcap's derivative ``1 - t^2``; float32 throughout, the
    gradients cast back to their inputs' dtypes."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    nc = max(1, Lk // chunk)
    ck = Lk // nc
    qf = q.float()
    dof = dout.float()
    delta = torch.sum(dof * out.float(), dim=-1)               # (B, H, Lq)
    dq = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=q.device)
    dk = torch.empty((B, H, Lk, D), dtype=torch.float32, device=q.device)
    dv = torch.empty((B, H, Lk, D), dtype=torch.float32, device=q.device)
    for c in range(nc):
        sl = slice(c * ck, (c + 1) * ck)
        kc, vc = k[:, :, sl].float(), v[:, :, sl].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kc) * scale
        t = None
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = softcap * t
        keep = _attn_mask(qpos, kpos[sl], causal=causal, window=window)
        s = torch.where(keep[None, None], s, NEG_INF)
        p = torch.exp(s - lse[..., None])                      # exact probs
        del s
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vc)
        ds = p * (dp - delta[..., None])
        del dp
        if t is not None:
            ds = ds * (1.0 - t * t)                            # d tanh
            del t
        dv[:, :, sl] = torch.einsum("bhqk,bhqd->bhkd", p, dof)
        del p
        dk[:, :, sl] = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, kc) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _MeaAttention(torch.autograd.Function):
    """:func:`mea_attention` with the reference's custom VJP: the forward
    saves q, k, v, the output and the log-sum-exp, never a chunk's
    probabilities, so the backward's memory stays O(L * chunk)."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, window, causal, scale, softcap,
                chunk):
        out, lse = _mea_forward(q, k, v, qpos, kpos, window, causal, scale,
                                softcap, chunk, with_lse=True)
        ctx.save_for_backward(q, k, v, qpos, kpos, out, lse)
        ctx.statics = (window, causal, scale, softcap, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qpos, kpos, out, lse = ctx.saved_tensors
        dq, dk, dv = _mea_backward(q, k, v, qpos, kpos, out, lse, dout,
                                   *ctx.statics)
        return dq, dk, dv, None, None, None, None, None, None, None


def mea_attention(q, k, v, qpos, kpos, window, causal, scale, softcap,
                  chunk):
    """The reference's memory-efficient attention: an online softmax over
    kv chunks of ``chunk`` keys, all in float32.

    q: (B, H, Lq, D); k, v: (B, H, Lk, D); qpos: (Lq,); kpos: (Lk,).
    ``window`` <= 0 means no window.  Returns (B, H, Lq, D) in q's dtype.
    When gradients flow to q, k or v it runs as a
    ``torch.autograd.Function`` whose backward is the reference's custom
    VJP (:func:`_mea_backward`); autograd through the chunk loop would
    save every chunk's probabilities, O(L^2) memory."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _MeaAttention.apply(q, k, v, qpos, kpos, window, causal,
                                   scale, softcap, chunk)
    return _mea_forward(q, k, v, qpos, kpos, window, causal, scale, softcap,
                        chunk)


def _pick_chunk(lk: int, target: int) -> int:
    """Largest divisor of lk that is <= target."""
    c = min(target, lk)
    while lk % c:
        c -= 1
    return max(c, 1)


def _project_qkv(cfg: ModelConfig, p, x, prefix: str, kv_x=None,
                 kv_cols: slice | None = None):
    """(B, L, H, hd) projections with the optional qkv bias; the keys and
    values from ``kv_x`` (B, Lk, d) where given (cross-attention).  The
    head counts are the weights' (a rank's own heads on a split step);
    ``kv_cols`` keeps those columns of whole key and value weights."""
    B, L, _ = x.shape
    hd = cfg.hd
    dt = x.dtype
    src = x if kv_x is None else kv_x
    Lk = src.shape[1]
    wk, wv = p[f"{prefix}_wk"], p[f"{prefix}_wv"]
    if kv_cols is not None:
        wk, wv = wk[:, kv_cols], wv[:, kv_cols]
    q = x @ p[f"{prefix}_wq"].to(dt)
    k = src @ wk.to(dt)
    v = src @ wv.to(dt)
    if cfg.qkv_bias:
        bk, bv = p[f"{prefix}_bk"], p[f"{prefix}_bv"]
        if kv_cols is not None:
            bk, bv = bk[kv_cols], bv[kv_cols]
        q = q + p[f"{prefix}_bq"].to(dt)
        k = k + bk.to(dt)
        v = v + bv.to(dt)
    return (q.reshape(B, L, -1, hd), k.reshape(B, Lk, -1, hd),
            v.reshape(B, Lk, -1, hd))


def _write_ring(cache, k, v, positions):
    """Write this call's keys, values and positions into one layer's ring,
    in place: slot ``position % W``.  A prompt longer than the ring keeps
    only its last W positions; they are consecutive, so their slots are
    distinct, and they are what writing every position in order leaves."""
    W = cache["k"].shape[2]
    if positions.shape[0] > W:
        k, v, positions = k[:, :, -W:], v[:, :, -W:], positions[-W:]
    slots = (positions % W).long()
    cache["k"].index_copy_(2, slots, k.to(cache["k"].dtype))
    cache["v"].index_copy_(2, slots, v.to(cache["v"].dtype))
    cache["pos"].index_copy_(0, slots, positions.to(cache["pos"].dtype))


def _write_ring_split(cache, k, v, positions, ring):
    """:func:`_write_ring` into this rank's block of a ring split by
    slots (``ring.span``): the block's k and v hold slots [s0, s1) of the
    W, ``pos`` all W.  Every rank of the slot team computes the same keys
    and values; each writes those whose slot it holds, with no host sync
    (the call's positions are consecutive, as prefill and decode make
    them):

      * one position (decode): its slot, or the block's old value where
        another rank holds it;
      * a prompt: each slot j of the block takes the position at offset
        (j - p0) mod W of the call when that is < L, else keeps its
        value (a prompt longer than the ring first keeps its last W)."""
    w_loc = cache["k"].shape[2]
    W = w_loc * ring.n_seq
    if positions.shape[0] > W:
        k, v, positions = k[:, :, -W:], v[:, :, -W:], positions[-W:]
    L = positions.shape[0]
    s0, _ = ring.span(w_loc)
    cache["pos"].index_copy_(0, (positions % W).long(),
                             positions.to(cache["pos"].dtype))
    if L == 1:
        local = positions % W - s0
        mine = ((local >= 0) & (local < w_loc))[None, None, :, None]
        at = local.clamp(0, w_loc - 1).long()
        for name, new in (("k", k), ("v", v)):
            old = cache[name].index_select(2, at)
            cache[name].index_copy_(
                2, at, torch.where(mine, new.to(old.dtype), old))
        return
    slots = torch.arange(s0, s0 + w_loc, device=positions.device)
    off = (slots - positions[0]) % W
    mine = (off < L)[None, None, :, None]
    at = off.clamp(max=L - 1).long()
    for name, new in (("k", k), ("v", v)):
        blk = cache[name]
        blk.copy_(torch.where(mine, new.index_select(2, at).to(blk.dtype),
                              blk))


def _kv_for_heads(kc, vc, heads: tuple[int, int], kv0: int, group: int):
    """The ring's kv heads (its first ``kv0``) for the query heads [qa,
    qb), grouped: (kc, vc, gq) with query head qa + i gq + j reading kv
    head i of the result; ``gq`` = ``group`` when [qa, qb) covers whole
    groups, the span's width when it reads one kv head, else 1 (each
    query head its own copy of its kv head)."""
    qa, qb = heads
    ka, kb = qa // group, (qb - 1) // group + 1
    if (ka, kb) != (kv0, kv0 + kc.shape[1]):
        kc, vc = kc[:, ka - kv0:kb - kv0], vc[:, ka - kv0:kb - kv0]
    if qa % group == 0 and qb - qa == (kb - ka) * group:
        return kc, vc, group
    if kb - ka == 1:
        return kc, vc, qb - qa
    idx = torch.arange(qa, qb, device=kc.device) // group - ka
    return kc.index_select(1, idx), vc.index_select(1, idx), 1


def _decode_attention(cfg: ModelConfig, q, cache, positions, *, causal,
                      window, scale, heads=None, kv0=0, ring=None):
    """One new query per sequence against the ring, K/V heads kept grouped
    (no repeat of the cache).  q: (B, Hs, 1, hd), the query heads
    ``heads`` = [qa, qb) (all by default) against the ring's kv heads
    from ``kv0`` on.  Logits in float32 of the compute-dtype operands,
    softcap, the ring's position mask; probabilities back in the compute
    dtype for P V.  Returns (B, Hs, 1, hd).

    With ``ring`` split by slots the ring is this rank's slots [s0, s1):
    the row maximum is the slot team's (``pmax``), then the sums of
    exponentials and of the probability-weighted values are summed over
    the team, so a rank whose slots are all empty adds exp(-1e30 - M) =
    0."""
    B, Hs, _, hd = q.shape
    dt = q.dtype
    kc, vc = cache["k"].to(dt), cache["v"].to(dt)
    kpos = cache["pos"]
    kc, vc, gq = _kv_for_heads(kc, vc, heads or (0, Hs), kv0,
                               cfg.n_heads // cfg.n_kv)
    qg = q.reshape(B, -1, gq, hd)
    logits = torch.matmul(qg.float(), kc.float().transpose(-1, -2))
    logits.mul_(scale)
    logits = _softcap(logits, cfg.softcap)
    split = ring is not None and ring.seq_axes
    if split:
        s0, s1 = ring.span(kc.shape[2])
        kpos = kpos[s0:s1]
    keep = _attn_mask(positions, kpos, causal=causal, window=window)
    logits.masked_fill_(~keep, NEG_INF)
    if not split:
        probs = torch.softmax(logits, dim=-1).to(dt)
        return torch.matmul(probs, vc).reshape(B, Hs, 1, hd)
    top = ring.pmax(torch.amax(logits, dim=-1, keepdim=True))
    e = torch.exp(logits - top)
    probs = (e / ring.psum(torch.sum(e, dim=-1, keepdim=True))).to(dt)
    out = ring.psum(torch.matmul(probs, vc).float()).to(dt)
    return out.reshape(B, Hs, 1, hd)


def _ring_attention(cfg: ModelConfig, q, cache, positions, *, causal, win,
                    scale, heads, kv0, ring):
    """A chunked-prefill segment's queries (B, Hs, L, hd), the query heads
    ``heads``, against this rank's slots of a ring split by slots: the
    memory-efficient online softmax over the block, unnormalised, its
    row maxima, sums and weighted values combined over the slot team.
    Returns (B, Hs, L, hd) in q's dtype."""
    dt = q.dtype
    kc, vc = cache["k"].to(dt), cache["v"].to(dt)
    s0, s1 = ring.span(kc.shape[2])
    group = cfg.n_heads // cfg.n_kv
    idx = torch.arange(*heads, device=q.device) // group - kv0
    kc, vc = kc.index_select(1, idx), vc.index_select(1, idx)
    m, l, acc = _mea_partial(q, kc, vc, positions, cache["pos"][s0:s1], win,
                             causal, scale, cfg.softcap,
                             _pick_chunk(kc.shape[2], cfg.attn_chunk))
    top = ring.pmax(m)
    alpha = torch.exp(m - top)
    l = ring.psum(l * alpha)
    acc = ring.psum(acc * alpha[..., None])
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(dt)


def attention(cfg: ModelConfig, p, x, positions, *, prefix="attn",
              causal=True, window=None, cache=None, kv_x=None,
              fresh_kv=True):
    """GQA attention.  x: (B, L, d); positions: (L,) absolute positions.
    Returns (out, cache).

    ``kv_x`` (B, Lk, d) makes it cross-attention (Whisper's decoder): the
    keys and values come from it, at key positions 0..Lk-1, with no RoPE,
    no causal mask and no cache.

    ``cache`` is None (the cache-free forward) or one layer's ring,
    ``{"k": (B, Hkv, W, hd), "v": ..., "pos": (W,) int32}`` with
    ``pos = -1`` on empty slots; this call's keys are written into it in
    place and it is returned.  With a cache:

      * L == 1 (decode): grouped attention over the whole ring;
      * ``fresh_kv=False`` (a chunked-prefill segment): the memory-
        efficient attention against the whole updated ring (its width is
        window + segment, so no key a query needs was overwritten);
      * ``fresh_kv=True`` (single-shot prefill): this call's keys are the
        whole history, so it runs the cache-free formulation.

    ``cfg.attention_impl`` "chunked" runs the reference's memory-
    efficient online softmax (:func:`mea_attention`); any other value
    runs the materialized einsum path ("ref").

    Inside ``parallel.split_model`` with the query heads split over the
    model team (``kv_x``, replicated over the team, enters as ``x``
    does), a rank computes its own query heads and the kv heads they
    read (its own block of the kv weights where the kv heads split too,
    else the columns it needs of the whole weights), and its rows of the
    output projection: partial sums, all-reduced over the team.  With a
    cache it holds this rank's block of the ring (``parallel.Ring``): its
    kv heads where they split over "model", else all of them, computed
    whole and written for the slots it holds; where the slots split
    (:func:`_write_ring_split`), decode and the chunked segments combine
    the slot team's partial softmaxes, each rank attending with every
    query head (gathered over the model team) when that team splits the
    slots; the single-shot prefill attends to its fresh keys as the
    cache-free split does."""
    B, L, d = x.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv
    dt = x.dtype
    tp = P.active()
    split = tp is not None and tp.heads
    ring = (tp.cached("ring") if tp is not None and cache is not None
            and kv_x is None else None)
    kv_cols = q_index = None
    kv0, heads = 0, (0, Hq)
    if split:
        x = tp.copy_to(x)
        if kv_x is not None:
            kv_x = tp.copy_to(kv_x)
        k0, k1 = tp.kv_heads(cfg)
        if tp.kv or ring is None:
            kv0 = k0
        if not tp.kv and ring is None:
            kv_cols = slice(k0 * hd, k1 * hd)
        heads = tp.q_span
        # each of the rank's query heads q reads kv head q // group
        q_index = (torch.arange(*heads, device=x.device)
                   // (Hq // Hkv) - kv0)
    q, k, v = _project_qkv(cfg, p, x, prefix, kv_x, kv_cols)
    if f"{prefix}_qnorm" in p:
        q = rmsnorm(q, p[f"{prefix}_qnorm"], cfg.norm_eps)
        k = rmsnorm(k, p[f"{prefix}_knorm"], cfg.norm_eps)
    kpos = positions
    if kv_x is not None:
        cache, causal = None, False
        kpos = torch.arange(k.shape[1], device=x.device)
    elif cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = q.transpose(1, 2)                             # (B, Hq, L, hd)
    k = k.transpose(1, 2)                             # (B, Hkv, Lk, hd)
    v = v.transpose(1, 2)

    scale = hd ** -0.5
    group = Hq // Hkv
    win = 0 if window is None else int(window)
    wo = p[f"{prefix}_wo"].to(dt)
    by_slots = ring is not None and bool(ring.seq_axes)
    # a rank of a model team that splits the slots attends with every
    # query head, then keeps its own heads' output
    q_att = q if not (by_slots and ring.q_all) else tp.gather_heads(q, 1)
    qheads = (0, Hq) if q_att is not q else heads

    def own(out):
        """(B, H, L, hd) of the heads attended: this rank's heads."""
        return out if q_att is q else out[:, heads[0]:heads[1]]

    if cache is not None:
        if by_slots:
            _write_ring_split(cache, k, v, positions, ring)
        else:
            _write_ring(cache, k, v, positions)

    if cache is not None and L == 1:
        out = own(_decode_attention(cfg, q_att, cache, positions,
                                    causal=causal, window=win, scale=scale,
                                    heads=qheads, kv0=kv0, ring=ring))
    elif cache is not None and not fresh_kv:
        if by_slots:
            out = own(_ring_attention(cfg, q_att, cache, positions,
                                      causal=causal, win=win, scale=scale,
                                      heads=qheads, kv0=kv0, ring=ring))
        else:
            kc, vc = cache["k"].to(dt), cache["v"].to(dt)
            if split:
                kc, vc = kc.index_select(1, q_index), vc.index_select(
                    1, q_index)
            elif group > 1:
                kc = torch.repeat_interleave(kc, group, dim=1)
                vc = torch.repeat_interleave(vc, group, dim=1)
            out = mea_attention(q, kc, vc, positions, cache["pos"], win,
                                causal, scale, cfg.softcap,
                                _pick_chunk(kc.shape[2], cfg.attn_chunk))
    else:
        if split:
            k, v = k.index_select(1, q_index), v.index_select(1, q_index)
        elif group > 1:
            k = torch.repeat_interleave(k, group, dim=1)
            v = torch.repeat_interleave(v, group, dim=1)
        if cfg.attention_impl == "chunked":
            out = mea_attention(q, k, v, positions, kpos, win, causal,
                                scale, cfg.softcap,
                                _pick_chunk(k.shape[2], cfg.attn_chunk))
        else:
            # float32 logits of the compute-dtype operands (the reference's
            # preferred_element_type=float32), masked in place
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
            logits.mul_(scale)
            logits = _softcap(logits, cfg.softcap)
            keep = _attn_mask(positions, kpos, causal=causal, window=win)
            logits.masked_fill_(~keep[None, None], NEG_INF)
            probs = torch.softmax(logits, dim=-1).to(dt)
            del logits
            out = torch.matmul(probs, v)
    out = out.to(dt).transpose(1, 2).reshape(B, L, -1) @ wo
    return (tp.reduce_from(out) if split else out), cache


def attention_flash(cfg: ModelConfig, p, x, positions, *, prefix="attn",
                    causal=True, window=None):
    """Self-attention through the flash-attention kernel (static window
    only).  As in the reference, this path applies no qk-norm.

    The kernel reads q, k and v as the (B, H, L, hd) transposed views of
    the (B, L, H, hd) projections, by strides, and writes its output in
    the same layout, so neither side copies."""
    B, L, _ = x.shape
    dt = x.dtype
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("the flash-attention kernel has no backward (nor "
                         "has the reference's); take gradients through "
                         "attention_impl='chunked' or 'ref'")
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
    """Inside ``parallel.split_model`` with ``d_ff`` split over the model
    team: a rank's columns of ``wg`` / ``wu`` (and ``bu``) and rows of
    ``wd``, the partial sums all-reduced before ``bd``."""
    dt = x.dtype
    tp = P.active()
    split = tp is not None and tp.mlp
    if split:
        x = tp.copy_to(x)
    if cfg.mlp == "swiglu":
        g = F.silu(x @ p[f"{prefix}_wg"].to(dt))
        u = x @ p[f"{prefix}_wu"].to(dt)
        out = (g * u) @ p[f"{prefix}_wd"].to(dt)
        return tp.reduce_from(out) if split else out
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p[f"{prefix}_wu"].to(dt) + p[f"{prefix}_bu"].to(dt),
               approximate="tanh")
    if split:
        return (tp.reduce_from(h @ p[f"{prefix}_wd"].to(dt))
                + p[f"{prefix}_bd"].to(dt))
    return h @ p[f"{prefix}_wd"].to(dt) + p[f"{prefix}_bd"].to(dt)


# ---------------------------------------------------------------------------
# MoE (token-choice top-k, capacity-bounded scatter dispatch)
# ---------------------------------------------------------------------------

def moe_schema(cfg: ModelConfig, prefix: str = "moe"):
    d = cfg.d_model
    # weights stored at DISPATCH granularity: with "ep_virtual" each
    # expert is split into virtual_split f-slices that behave as
    # independent experts (y = x Wg1 Wd1 + x Wg2 Wd2 is exact)
    E, f = cfg.n_experts_disp, cfg.d_ff_expert_disp
    return {
        f"{prefix}_router": ((d, cfg.n_experts), ("embed", "expert"),
                             fan_in(d)),
        f"{prefix}_wg": ((E, d, f), ("expert", "embed", "expert_mlp"),
                         fan_in(d)),
        f"{prefix}_wu": ((E, d, f), ("expert", "embed", "expert_mlp"),
                         fan_in(d)),
        f"{prefix}_wd": ((E, f, d), ("expert", "expert_mlp", "embed"),
                         fan_in(f)),
    }


CAPACITY_QUANTUM = 4096  # divisible by any (pod x data) shard count


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    q = CAPACITY_QUANTUM if n_tokens >= CAPACITY_QUANTUM else 128
    return max(q, -(-c // q) * q)


def positions_in_expert(flat_ids, n_experts: int):
    """Position of each assignment within its expert, in flat order: an
    exact int32 prefix count over a (n, E) hit matrix.  (The reference's
    block-triangular matmul is a TPU device for the same numbers.)"""
    n = flat_ids.shape[0]
    ids = flat_ids.long()[:, None]
    hits = torch.zeros((n, n_experts), dtype=torch.int32,
                       device=flat_ids.device).scatter_(1, ids, 1)
    counts = torch.cumsum(hits, dim=0, dtype=torch.int32)
    return counts.gather(1, ids)[:, 0] - 1


def router_top_k(logits, k: int):
    """``lax.top_k``: the k largest per row, descending, equal values in
    ascending index order (a stable sort; ``torch.topk`` promises no
    order among ties, and bf16 router logits do tie)."""
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


class DropTally:
    """Assignments a :func:`count_moe_drops` block dispatched, and those
    capacity dropped; the count stays on the device until the block
    closes."""

    def __init__(self):
        self.assigned = 0
        self.dropped = 0
        self._dropped = None

    def add(self, keep):
        n = (~keep).sum()
        self._dropped = n if self._dropped is None else self._dropped + n
        self.assigned += keep.numel()

    def close(self):
        if self._dropped is not None:
            self.dropped = int(self._dropped)


_DROP_TALLY: DropTally | None = None


@contextlib.contextmanager
def count_moe_drops():
    """Count the (token, expert) assignments that every :func:`apply_moe`
    inside the block drops for capacity.  Yields a :class:`DropTally`
    whose ``dropped`` is read (one host sync) when the block closes;
    outside a block nothing is counted."""
    global _DROP_TALLY
    tally, prev = DropTally(), _DROP_TALLY
    _DROP_TALLY = tally
    try:
        yield tally
    finally:
        _DROP_TALLY = prev
        tally.close()


def batch_axes(cfg: ModelConfig, mesh) -> tuple[str, ...]:
    """The mesh axes the batch rule shards over (``("pod", "data")`` by
    default, those the mesh has), in the mesh's order."""
    rule = cfg.rules().get("batch", ("pod", "data"))
    return tuple(a for a in mesh.axis_names if a in rule)


def moe_shardable(cfg: ModelConfig, n_tokens: int, n: int) -> bool:
    """The reference's condition for the per-shard dispatch of
    ``n_tokens`` tokens over ``n`` shards: both the tokens and the
    capacity split evenly (a model without experts: always)."""
    if not cfg.n_experts:
        return True
    return n_tokens % n == 0 and moe_capacity(cfg, n_tokens) % n == 0


#: (mesh, rows_sharded) inside :func:`batch_shards`, else None
_BATCH_SHARDS: tuple | None = None


@contextlib.contextmanager
def batch_shards(mesh, rows_sharded: bool):
    """Inside the block, :func:`apply_moe` dispatches per shard of the
    batch team of ``mesh`` (:func:`batch_axes`), as the reference does
    under a mesh.  ``rows_sharded``: the batch a forward sees is this
    rank's contiguous block of the team's rows; else every rank sees the
    whole batch (rows that do not divide the team) and dispatches the
    team's token blocks one after the other itself."""
    global _BATCH_SHARDS
    prev = _BATCH_SHARDS
    _BATCH_SHARDS = (mesh, rows_sharded)
    try:
        yield
    finally:
        _BATCH_SHARDS = prev


class _TeamSum(torch.autograd.Function):
    """The sum of ``x`` over a mesh team, its gradient ``n`` times the
    incoming one.  The adjoint of the sum is the team sum of the
    gradients; inside the MoE aux loss every rank's incoming gradient is
    the same (the loss reads only team sums), so that sum is ``n`` times
    the rank's own, with no collective in the backward.  The train step
    then averages the ranks' gradients over the team, which leaves each
    rank's tokens their exact share."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.n = mesh.axes_size(axes)
        return mesh.psum(x, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.n, None, None


def _moe_dispatch_local(cfg: ModelConfig, xt, router, c_loc: int):
    """Router -> top-k -> positions within each expert -> scatter into a
    (E, c_loc, d) capacity buffer.  Kept slots are distinct; dropped
    assignments go to a sentinel row that is thrown away, so the scatter
    is deterministic.  Returns (buf, slot, gates, keep, (me_sum, ce_sum))
    as the reference does."""
    dt = xt.dtype
    E, K = cfg.n_experts, cfg.top_k
    t_loc, d = xt.shape
    logits = (xt @ router.to(dt)).float()
    gate_vals, ids = router_top_k(logits, K)
    gates = torch.softmax(gate_vals, dim=-1)

    # load-balance aux (Switch-style): softmax mass and selection count
    # per expert, summed over the tokens
    me_sum = torch.softmax(logits, dim=-1).sum(dim=0)
    ce_sum = torch.zeros(E, dtype=torch.float32, device=xt.device)
    ce_sum.index_add_(0, ids.reshape(-1),
                      torch.ones(ids.numel(), dtype=torch.float32,
                                 device=xt.device))

    if cfg.expert_sharding == "ep_virtual":
        # expand each assignment to its virtual f-slices; same gate on
        # every slice (their partial outputs sum to the expert output)
        v = cfg.virtual_split
        ids = (ids[..., None] * v + torch.arange(
            v, device=ids.device)).reshape(t_loc, K * v)
        gates = torch.repeat_interleave(gates, v, dim=-1)
        E, K = E * v, K * v

    flat_ids = ids.reshape(-1)
    pos = positions_in_expert(flat_ids, E)
    keep = pos < c_loc
    slot = torch.where(keep, flat_ids * c_loc + pos, E * c_loc)
    xr = xt[:, None].expand(t_loc, K, d).reshape(t_loc * K, d)
    buf = torch.zeros((E * c_loc + 1, d), dtype=dt, device=xt.device)
    buf.index_copy_(0, slot, xr)
    return (buf[:-1].view(E, c_loc, d), slot, gates, keep,
            (me_sum, ce_sum))


def _moe_combine_local(out_e_loc, slot, gates, keep, K: int):
    """Gather each assignment's expert output back to its token, weighted
    by its gate (0 where dropped), and sum over the token's K."""
    E, c_loc, d = out_e_loc.shape
    flat = out_e_loc.reshape(E * c_loc, d)
    g = flat[slot.clamp(max=E * c_loc - 1)]
    g = g * (gates.reshape(-1)[:, None] * keep[:, None]).to(flat.dtype)
    return g.view(-1, K, d).sum(dim=1)                    # (T, d)


def apply_moe(cfg: ModelConfig, p, x, prefix: str = "moe"):
    """x: (B, L, d).  Token-choice top-k with capacity and dropping.
    Returns (out, aux_loss).

    The reference's unsharded branch: one dispatch over all B * L tokens
    into an (E, C, d) buffer, every expert's MLP over its C slots as one
    batched product, and the combine.  ``expert_sharding`` "ep" and "tp"
    differ only in how the reference shards the weights, so they run
    alike here; "ep_virtual" dispatches to the f-slices.

    Inside :func:`batch_shards` with a batch team of n > 1 ranks whose
    tokens and capacity C split evenly (the reference's condition, on
    the team's T tokens), the per-shard branch runs instead: each of the
    n contiguous blocks of T / n tokens dispatches into its own (E, C /
    n, d) buffer, the aux loss's statistics are summed over the team,
    and each block combines from its own buffer, so which tokens are
    dropped depends on the blocks, as in the reference.

    Inside ``parallel.split_model`` with the experts split over the model
    team, every rank dispatches its tokens as above (each rank of a data
    shard holds the same tokens, so no token moves) and then: under "ep"
    (and "ep_virtual", over the dispatch experts) runs the MLP of its own
    experts on its block of the whole buffer and gathers every expert's
    output back, so the combine and the aux loss run whole and alike on
    every rank, in one process's order (the reference's ``shard_map``
    combine reads the outputs whole too); under "tp" runs every expert on
    its columns of ``d_ff_expert``, its combine a partial sum all-reduced
    over the team, and the aux loss, computed whole on every rank, enters
    as ``reduce_from(aux / m)``."""
    tp = P.active()
    if tp is not None and tp.experts == "tp":
        out, aux = _apply_moe(cfg, p, tp.copy_to(x), prefix, None)
        return tp.reduce_from(out), tp.reduce_from(aux / tp.m)
    split = tp if tp is not None and tp.experts == "ep" else None
    return _apply_moe(cfg, p, x, prefix, split)


def _apply_moe(cfg: ModelConfig, p, x, prefix, split):
    B, L, d = x.shape
    T = B * L
    if _BATCH_SHARDS is not None:
        mesh, rows_sharded = _BATCH_SHARDS
        axes = batch_axes(cfg, mesh)
        n = mesh.axes_size(axes)
        t_team = T * n if rows_sharded else T
        if n > 1 and moe_shardable(cfg, t_team, n):
            return _apply_moe_sharded(cfg, p, x, prefix, mesh, axes, n,
                                      t_team, rows_sharded, split)
        if rows_sharded and n > 1:
            raise ValueError(
                f"{t_team} tokens do not dispatch per shard over {n} "
                f"ranks (capacity {moe_capacity(cfg, t_team)}); replicate "
                f"the batch over the team (lm.make_train_step does)")
    dt = x.dtype
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, T)
    buf, slot, gates, keep, (me_s, ce_s) = _moe_dispatch_local(
        cfg, x.reshape(T, d), p[f"{prefix}_router"], C)
    if _DROP_TALLY is not None:
        _DROP_TALLY.add(keep)
    aux = E * torch.sum((me_s / T) * (ce_s / T))
    out = _moe_experts(cfg, p, buf, slot, gates, keep, prefix, dt, split)
    return out.reshape(B, L, d), aux


def _moe_experts(cfg: ModelConfig, p, buf, slot, gates, keep, prefix, dt,
                 split=None):
    """Every expert's MLP over its slots of ``buf`` (E, c, d), then the
    combine of each token's assignments: (tokens, d).  ``split``: the
    ``parallel.Split`` whose rank holds its block of the experts only;
    it runs that block of ``buf`` and gathers the outputs whole."""
    K_comb = cfg.top_k * (cfg.virtual_split
                          if cfg.expert_sharding == "ep_virtual" else 1)
    wg, wu, wd = (p[f"{prefix}_{w}"].to(dt) for w in ("wg", "wu", "wd"))
    if split is not None:
        buf = split.block_of(buf, 0)
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    out_e = torch.bmm(h, wd)                              # (E, c, d)
    if split is not None:
        out_e = split.gather_whole(out_e, 0)
    return _moe_combine_local(out_e, slot, gates, keep, K_comb)


def _apply_moe_sharded(cfg: ModelConfig, p, x, prefix, mesh, axes, n: int,
                       t_team: int, rows_sharded: bool, split):
    """The per-shard branch of :func:`apply_moe` over the team's
    ``t_team`` tokens: this rank's block alone when the rows are
    sharded (the statistics summed over the team), else all n blocks in
    turn."""
    B, L, d = x.shape
    dt = x.dtype
    c_loc = moe_capacity(cfg, t_team) // n
    router = p[f"{prefix}_router"]
    xt = x.reshape(B * L, d)
    blocks = [xt] if rows_sharded else list(xt.chunk(n))
    parts = [_moe_dispatch_local(cfg, blk, router, c_loc) for blk in blocks]
    me_s = sum(part[4][0] for part in parts)
    ce_s = sum(part[4][1] for part in parts)
    if rows_sharded:
        me_s = _TeamSum.apply(me_s, mesh, axes)
        ce_s = mesh.psum(ce_s, axes)
    aux = cfg.n_experts * torch.sum((me_s / t_team) * (ce_s / t_team))
    outs = []
    for buf, slot, gates, keep, _ in parts:
        if _DROP_TALLY is not None:
            _DROP_TALLY.add(keep)
        outs.append(_moe_experts(cfg, p, buf, slot, gates, keep, prefix,
                                 dt, split))
    return torch.cat(outs).reshape(B, L, d), aux
