"""Mamba2 (SSD — state-space duality) blocks: the chunked-scan forward,
the one-step decode recurrence, and the block with its conv and state
cache.

Port of ``repro.models.ssm``.  Shapes follow the Mamba2 paper: d_inner
= expand * d_model, heads nh = d_inner / headdim, per-head state size
N = ssm_state, B/C shared across heads in ssm_ngroups groups.  The
chunked algorithm splits L into chunks of Q tokens: the intra-chunk
terms are a masked quadratic form, the inter-chunk terms a length-L/Q
recurrence over the running state h: (nh, hp, N), which is what makes
decode O(1) in the sequence length.

The reference's numerics are kept: every SSD operand is cast to float32
and the state ``h`` is float32 whatever the compute dtype; the conv, the
skip and the gated norm run in the compute dtype.  The reference's
inter-chunk ``lax.scan`` is a Python loop over the L / Q chunks.

Inside ``parallel.split_model`` with the SSM heads split over the model
team (a train step on a mesh), a block computes this rank's heads: their
columns of z, x and dt, the B / C groups they read (each head its own
group, wherever the rank's heads fall), the conv on those channels, its
rows of the out-projection (partial sums, all-reduced), and the gated
norm's mean square summed over the team.  Serving there holds this
rank's blocks of the state (``parallel.SsmState``): ``conv`` is read
whole (its "model" blocks follow the channels, not the heads) and the
block of the new rows kept; ``h`` is the rank's heads where they split.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import parallel as P
from .config import ModelConfig
from .layers import fan_in, rmsnorm


def ssm_schema(cfg: ModelConfig, prefix: str = "ssm"):
    d = cfg.d_model
    di = cfg.d_inner
    g, ns, nh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    conv_dim = di + 2 * g * ns
    return {
        f"{prefix}_in": ((d, 2 * di + 2 * g * ns + nh),
                         ("embed", "heads"), fan_in(d)),
        f"{prefix}_conv": ((cfg.ssm_conv, conv_dim), ("none", "heads"),
                           fan_in(cfg.ssm_conv)),
        f"{prefix}_conv_b": ((conv_dim,), ("heads",), 0.0),
        f"{prefix}_alog": ((nh,), ("none",), 1.0),     # A = -exp(alog)
        f"{prefix}_dtb": ((nh,), ("none",), 0.0),      # dt bias
        f"{prefix}_d": ((nh,), ("none",), 1.0),        # skip D
        f"{prefix}_gnorm": ((di,), ("none",), 0.0),    # gated RMSNorm
        f"{prefix}_out": ((di, d), ("heads", "embed"), fan_in(di)),
    }


def _split_in(zxbcdt, di: int, gn: int, nh: int):
    """z, xbc (x | B | C) and dt of the in-projection's output, for
    ``di`` channels of x, ``gn`` of B (and of C) and ``nh`` heads."""
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * gn]
    dt = zxbcdt[..., -nh:]
    return z, xbc, dt


def _rank_columns(cfg: ModelConfig, heads: tuple[int, int],
                  groups: tuple[int, int], device=None):
    """This rank's columns of the in-projection (z | x | B | C | dt) and
    channels of the conv (x | B | C): the heads [h0, h1) and the B / C
    groups [g0, g1) they read."""
    di, ns, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_headdim
    gn = cfg.ssm_ngroups * ns
    (h0, h1), (g0, g1) = heads, groups
    x = torch.arange(h0 * hp, h1 * hp, device=device)
    bc = torch.arange(g0 * ns, g1 * ns, device=device)
    conv = torch.cat([x, di + bc, di + gn + bc])
    dt = torch.arange(2 * di + 2 * gn + h0, 2 * di + 2 * gn + h1,
                      device=device)
    return torch.cat([x, di + conv, dt]), conv


def _per_head(t, rep: int, group_of):
    """(..., g, N) groups -> (..., nh, N) heads: head h reads group
    ``group_of[h]``, else h // rep."""
    if group_of is None:
        return torch.repeat_interleave(t, rep, dim=-2)
    return t.index_select(t.dim() - 2, group_of)


def _causal_conv(xbc, w, b, *, state=None):
    """Depthwise causal conv over time, then SiLU.  xbc: (B, L, C); w:
    (K, C); b: (C,).

    state: (B, K-1, C) previous inputs (decode, chunked prefill), or None
    for zeros.  Returns (out, new_state): the new state is the last K-1
    inputs (None when K == 1)."""
    K = w.shape[0]
    if state is None:
        pad = xbc.new_zeros(xbc.shape[:1] + (K - 1,) + xbc.shape[2:])
    else:
        pad = state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)                   # (B, L+K-1, C)
    L = xbc.shape[1]
    out = full[:, 0:L] * w[0]
    for i in range(1, K):
        out = out + full[:, i:i + L] * w[i]
    new_state = full[:, -(K - 1):] if K > 1 else None
    return F.silu(out + b), new_state


def segsum(x):
    """Stable segment sum: out[..., i, j] = sum_{j < k <= i} x[..., k],
    -inf above the diagonal."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): no threshold switch."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def ssd_chunked(x, dt, a, b, c, *, chunk: int, h0=None, group_of=None):
    """SSD forward.  x: (B, L, nh, hp); dt: (B, L, nh) (post-softplus);
    a: (nh,) negative; b, c: (B, L, g, N); h0: (B, nh, hp, N) or None;
    ``group_of`` (nh,) each head's group among b's and c's, or None for
    nh / g consecutive heads per group.  Returns (y in x's dtype, h_last
    (B, nh, hp, N) float32).

    At most two (B, L/Q, nh, Q, Q) float32 tensors are live at a time:
    the decay matrix and the scores, multiplied in place."""
    B, L, nh, hp = x.shape
    g, N = b.shape[2], b.shape[3]
    Q = min(chunk, L)
    L_real = L
    if L % Q:
        # zero padding: dt = 0 gives unit decay and zero input, so the
        # result and the final state are exact
        pad = Q - L % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        L = L + pad
    nc = L // Q
    rep = nh // g

    f32 = torch.float32
    xc = x.reshape(B, nc, Q, nh, hp).to(f32)
    dtc = dt.reshape(B, nc, Q, nh).to(f32)
    bc = _per_head(b.reshape(B, nc, Q, g, N), rep, group_of).to(f32)
    cc = _per_head(c.reshape(B, nc, Q, g, N), rep, group_of).to(f32)
    da = dtc * a.to(f32)                                  # (B, nc, Q, nh)
    xdt = xc * dtc[..., None]

    # intra-chunk: (C B^T * decay) (x dt), the decay matrix formed first
    lmat = torch.exp(segsum(da.permute(0, 1, 3, 2)))      # (B, nc, nh, Q, Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", cc, bc)
    scores.mul_(lmat)
    del lmat
    y = torch.einsum("bchqk,bckhp->bcqhp", scores, xdt)
    del scores

    # chunk states: S_c = sum_j exp(sum_{k>j} da_k) b_j x_j^T
    cum = torch.cumsum(da, dim=2)
    decay_to_end = torch.exp(cum[:, :, -1:] - cum)        # (B, nc, Q, nh)
    states = torch.einsum("bcqhn,bcqhp->bchpn", bc,
                          xdt * decay_to_end[..., None])

    # inter-chunk recurrence over the running state
    chunk_decay = torch.exp(cum[:, :, -1])                # (B, nc, nh)
    h = (torch.zeros((B, nh, hp, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    h_befores = torch.empty((B, nc, nh, hp, N), dtype=f32, device=x.device)
    for i in range(nc):
        h_befores[:, i] = h
        h = h * chunk_decay[:, i, :, None, None] + states[:, i]

    in_decay = torch.exp(cum)                             # (B, nc, Q, nh)
    y = y + torch.einsum("bcqhn,bchpn->bcqhp", cc * in_decay[..., None],
                         h_befores)
    y = y.reshape(B, L, nh, hp)[:, :L_real]
    return y.to(x.dtype), h


def ssd_recurrent_ref(x, dt, a, b, c, *, h0=None, group_of=None):
    """The per-step recurrence (the plain oracle, and the decode step's
    semantics).  Shapes as in :func:`ssd_chunked`."""
    B, L, nh, hp = x.shape
    g, N = b.shape[2], b.shape[3]
    rep = nh // g
    f32 = torch.float32
    bf = _per_head(b, rep, group_of).to(f32)
    cf = _per_head(c, rep, group_of).to(f32)
    dtf = dt.to(f32)
    af = a.to(f32)
    h = (torch.zeros((B, nh, hp, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    ys = []
    for t in range(L):
        dec = torch.exp(dtf[:, t] * af)                   # (B, nh)
        xt = x[:, t].to(f32) * dtf[:, t, :, None]         # (B, nh, hp)
        h = h * dec[..., None, None] + xt[..., None] * bf[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhpn->bhp", cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def mamba2_block(cfg: ModelConfig, p, x, *, prefix="ssm", cache=None):
    """The Mamba2 block.  x: (B, L, d).  ``cache`` is None or one layer's
    ``{"conv": (B, K-1, conv_dim), "h": (B, nh, hp, N)}``, read as the
    state before this call and written in place with the state after it
    (decode, chunked prefill).  Returns (out, cache).

    Inside ``parallel.split_model`` with the SSM heads split, this rank's
    heads only: see the module's docstring.  With a cache there, the
    cache holds this rank's blocks: the conv state is gathered whole over
    the axes its spec splits its channels over, and the block of the new
    rows (the last K-1 inputs of its channels, the in-projection's
    columns of the block taken for the call's last K-1 positions) written
    back; ``h`` is the rank's heads where the compute splits them, else
    gathered whole and its block kept."""
    B, L, d = x.shape
    dt_ = x.dtype
    ns, hp = cfg.ssm_state, cfg.ssm_headdim
    w_in, w_conv, b_conv = (p[f"{prefix}_in"], p[f"{prefix}_conv"],
                            p[f"{prefix}_conv_b"])
    alog, dtb, skip = (p[f"{prefix}_alog"], p[f"{prefix}_dtb"],
                       p[f"{prefix}_d"])
    gnorm = p[f"{prefix}_gnorm"]
    tp = P.active()
    split = tp is not None and tp.ssm
    st = (tp.cached("ssm_state") if tp is not None and cache is not None
          else None)
    conv0 = h0 = None
    if cache is not None:
        conv0, h0 = cache["conv"], cache["h"]
        if st is not None:
            conv0 = st.mesh.gather(conv0, st.conv_spec)
            if not st.h_own:
                h0 = st.mesh.gather(h0, st.h_spec)
    state_in = conv0
    group_of = None
    if split:
        x = tp.copy_to(x)
        (h0_, h1_), (g0, g1) = tp.ssm_span, tp.ssm_groups
        cols, chans = _rank_columns(cfg, tp.ssm_span, tp.ssm_groups,
                                    x.device)
        w_in = w_in.index_select(1, cols)
        w_conv = w_conv.index_select(1, chans)
        b_conv = b_conv.index_select(0, chans)
        if conv0 is not None:
            state_in = conv0.index_select(2, chans)
        alog, dtb, skip = alog[h0_:h1_], dtb[h0_:h1_], skip[h0_:h1_]
        gnorm = gnorm[h0_ * hp:h1_ * hp]
        # each of the rank's heads reads its own group, wherever the
        # rank's heads fall among the groups
        group_of = (torch.arange(h0_, h1_, device=x.device)
                    // (cfg.ssm_nheads // cfg.ssm_ngroups) - g0)
        nh, g = h1_ - h0_, g1 - g0
    else:
        nh, g = cfg.ssm_nheads, cfg.ssm_ngroups
    di = nh * hp

    zxbcdt = x @ w_in.to(dt_)
    z, xbc, dtr = _split_in(zxbcdt, di, g * ns, nh)
    xbc, new_conv = _causal_conv(xbc, w_conv.to(dt_), b_conv.to(dt_),
                                 state=state_in)
    xs = xbc[..., :di].reshape(B, L, nh, hp)
    bmat = xbc[..., di:di + g * ns].reshape(B, L, g, ns)
    cmat = xbc[..., di + g * ns:].reshape(B, L, g, ns)
    dt = _softplus(dtr.float() + dtb.float())
    a = -torch.exp(alog.float())

    if L == 1:  # decode: one recurrence step, no chunking
        y, h = ssd_recurrent_ref(xs, dt, a, bmat, cmat, h0=h0,
                                 group_of=group_of)
    else:
        y, h = ssd_chunked(xs, dt, a, bmat, cmat, chunk=cfg.ssm_chunk,
                           h0=h0, group_of=group_of)
    y = y + xs * skip.to(dt_)[None, None, :, None]
    y = y.reshape(B, L, di) * F.silu(z)
    if split:
        y = _team_rmsnorm(tp, y, gnorm, cfg.norm_eps, cfg.d_inner)
        out = tp.reduce_from(y @ p[f"{prefix}_out"].to(dt_))
    else:
        y = rmsnorm(y, gnorm, cfg.norm_eps)
        out = y @ p[f"{prefix}_out"].to(dt_)
    if cache is not None:
        if st is None:
            cache["conv"].copy_(new_conv)
        elif split:
            cache["conv"].copy_(_conv_block(cfg, st, p[f"{prefix}_in"], x,
                                            conv0))
        else:
            cache["conv"].copy_(st.mesh.shard(new_conv, st.conv_spec))
        cache["h"].copy_(h if st is None or st.h_own
                         else st.mesh.shard(h, st.h_spec))
    return out, cache


def _conv_block(cfg: ModelConfig, st, w_in, x, conv0):
    """This rank's block [c0, c1) of the conv state after a call on ``x``
    (B, L, d), from the whole state before it (``conv0``): the last K-1
    of the block's old rows and its new inputs, the in-projection's
    columns of those channels applied to the call's last K-1
    positions."""
    K = cfg.ssm_conv
    c0, c1 = st.conv_span(conv0.shape[-1])
    tail = x[:, -(K - 1):]
    di = cfg.d_inner
    rows = tail @ w_in[:, di + c0:di + c1].to(x.dtype)
    full = torch.cat([conv0[..., c0:c1].to(x.dtype), rows], dim=1)
    return full[:, -(K - 1):]


def _team_rmsnorm(tp, x, scale, eps, width: int):
    """``layers.rmsnorm`` over ``width`` channels of which this rank holds
    ``x``'s: the sum of squares all-reduced over the model team.  The
    normalised channels feed split compute again, so each rank's gradient
    of the sum is its share: ``copy_to`` sums them in the backward."""
    dt = x.dtype
    x = x.float()
    ss = tp.copy_to(tp.reduce_from(torch.sum(x * x, dim=-1, keepdim=True)))
    return ((x * torch.rsqrt(ss / width + eps))
            * (1.0 + scale.float())).to(dt)


def ssm_cache_shape(cfg: ModelConfig, batch: int):
    di = cfg.d_inner
    conv_dim = di + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "conv": (batch, cfg.ssm_conv - 1, conv_dim),
        "h": (batch, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state),
    }
