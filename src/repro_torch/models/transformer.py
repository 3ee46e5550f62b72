"""Model assembly of the LM zoo, with and without the serve path's cache,
for every family:

  * decoder-only (dense / moe / vlm), with gemma2's per-layer windows;
  * ssm (mamba2): a stack of Mamba2 blocks;
  * hybrid (zamba2): groups, each one invocation of the SHARED attention
    block (a single parameter set, its own KV ring per group) followed
    by ``shared_every`` Mamba2 layers;
  * audio enc-dec (whisper): a bidirectional encoder over stub frame
    embeddings and a causal decoder with cross-attention.

Port of ``repro.models.transformer``.  The reference keeps its
parameters as a pytree with the layers stacked for ``lax.scan``; the port
keeps them in a :class:`DecoderLM` module whose stacked groups
(``blocks``, Whisper's ``enc``) are ``ModuleList``\\ s of one
:class:`ParamBlock` per layer, each holding the schema's names as its
parameters, and runs the layers in Python loops.  ``forward``,
``encode``, ``lm_head``, ``init_params`` and ``init_cache`` keep the
reference's names.  The forward reads its weights from a
:class:`DecoderLM` or from a :class:`Weights` (``lm.cast_params``'s
compute-dtype copy, whose tensors stay on the master's autograd graph).

With ``cfg.remat`` and gradients on, the cache-free forward checkpoints
every layer (``torch.utils.checkpoint``), as the reference's
``_maybe_remat`` does, and with ``cfg.remat_group`` > 1 (dividing the
layer count) groups of layers as well, as its ``_grouped_scan``: only
the residual stream between groups is kept for the backward, at about
one extra forward of recompute.  Serving (a cache, or no gradients)
never recomputes.

The cache is the reference's stacked tree (:func:`init_cache`); each
layer writes its slice in place, so the cache is never double-buffered
(the reference's ``_serve_loop`` carries it through a ``fori_loop`` for
the same end).  Serving on a mesh (``lm.make_prefill(..., mesh=)``)
reads every layer's blocks through ``parallel.view`` as the train step
does, and the cache holds this rank's blocks.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import layers as L
from . import parallel as P
from . import ssm as S
from .config import ModelConfig

# ---------------------------------------------------------------------------
# schemas
# ---------------------------------------------------------------------------


def decoder_block_schema(cfg: ModelConfig):
    s = {}
    s.update(L.norm_schema(cfg, "ln1"))
    s.update(L.norm_schema(cfg, "ln2"))
    if cfg.post_norm:
        s.update(L.norm_schema(cfg, "pn1"))
        s.update(L.norm_schema(cfg, "pn2"))
    s.update(L.attn_schema(cfg))
    if cfg.n_experts:
        s.update(L.moe_schema(cfg))
    else:
        s.update(L.mlp_schema(cfg))
    return s


def ssm_block_schema(cfg: ModelConfig):
    s = {}
    s.update(L.norm_schema(cfg, "ln1"))
    s.update(S.ssm_schema(cfg))
    return s


def enc_block_schema(cfg: ModelConfig):
    s = {}
    s.update(L.norm_schema(cfg, "ln1"))
    s.update(L.norm_schema(cfg, "ln2"))
    s.update(L.attn_schema(cfg))
    s.update(L.mlp_schema(cfg))
    return s


def xdec_block_schema(cfg: ModelConfig):
    """Whisper decoder block: self-attn + cross-attn + mlp."""
    s = {}
    s.update(L.norm_schema(cfg, "ln1"))
    s.update(L.norm_schema(cfg, "ln2"))
    s.update(L.norm_schema(cfg, "ln3"))
    s.update(L.attn_schema(cfg, "attn"))
    s.update(L.attn_schema(cfg, "xattn"))
    s.update(L.mlp_schema(cfg))
    return s


def model_schema(cfg: ModelConfig, max_len: int = 0):
    """The reference's schema tree, with ``blocks`` (and Whisper's
    ``enc``) stacked over the layers."""
    d, V = cfg.d_model, cfg.vocab_pad
    tree = {
        "embed": {"tok": ((V, d), ("vocab", "embed"), 1e-2)},
        "final": L.norm_schema(cfg, "fn"),
    }
    if not cfg.tie_embeddings:
        tree["embed"]["unembed"] = ((V, d), ("vocab", "embed"), 1e-2)
    if cfg.rope_theta == 0:  # learned absolute positions (whisper)
        tree["embed"]["pos"] = ((max_len, d), ("none", "embed"), 1e-2)
    if cfg.family == "ssm":
        tree["blocks"] = L.stack_schema(ssm_block_schema(cfg), cfg.n_layers)
    elif cfg.family == "hybrid":
        tree["blocks"] = L.stack_schema(ssm_block_schema(cfg), cfg.n_layers)
        shared = {}
        shared.update(L.norm_schema(cfg, "ln1"))
        shared.update(L.norm_schema(cfg, "ln2"))
        shared.update(L.attn_schema(cfg))
        shared.update(L.mlp_schema(cfg))
        tree["shared"] = shared
    elif cfg.enc_dec:
        tree["embed"]["pos_enc"] = ((cfg.enc_len, d), ("none", "embed"), 1e-2)
        tree["enc"] = L.stack_schema(enc_block_schema(cfg), cfg.n_enc_layers)
        tree["enc_final"] = L.norm_schema(cfg, "efn")
        tree["blocks"] = L.stack_schema(xdec_block_schema(cfg), cfg.n_layers)
    else:
        tree["blocks"] = L.stack_schema(decoder_block_schema(cfg),
                                        cfg.n_layers)
    return tree


def logical_axes(cfg: ModelConfig, max_len: int = 0) -> dict:
    """The reference's logical-axes tree of the parameters: each group's
    names to their logical axes, the stacked groups with their leading
    ``"layers"`` axis (one block of the port's holds ``[1:]`` of it)."""
    return {name: L.build_logical(sub)
            for name, sub in model_schema(cfg, max_len).items()}


def stacked_groups(cfg: ModelConfig) -> dict:
    """The groups kept as one block per layer, and their layer counts."""
    return {"blocks": cfg.n_layers, "enc": cfg.n_enc_layers}


class ParamBlock(nn.Module):
    """A flat group of named tensors (one schema), read as a mapping:
    ``p["attn_wq"]``, ``"attn_qnorm" in p``.  The parameters are made
    frozen, so evaluating the loss or serving builds no autograd graph;
    ``lm.init_train_state`` turns them into trainable leaves
    (``requires_grad_()``)."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name in sorted(tensors):
            self.register_parameter(
                name, nn.Parameter(tensors[name], requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._parameters[name]

    def __contains__(self, name: str) -> bool:
        return name in self._parameters

    def tensors(self) -> dict:
        return dict(self._parameters)


class DecoderLM(nn.Module):
    """Parameters of an LM of the zoo, one attribute per group of the
    schema: ``embed`` (tok, unembed, pos, pos_enc) and ``final`` (the
    final norm) always; ``blocks`` (one per layer); Zamba2's ``shared``
    attention block; Whisper's ``enc`` (one per encoder layer) and
    ``enc_final``.  ``tree`` is ``{group: {name: tensor}}``, a list of
    such dicts for the stacked groups."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        want = set(model_schema(cfg))
        if set(tree) != want:
            raise ValueError(f"{cfg.name} has the groups {sorted(want)}, "
                             f"got {sorted(tree)}")
        stacked = stacked_groups(cfg)
        for name in sorted(tree):
            if name in stacked:
                if len(tree[name]) != stacked[name]:
                    raise ValueError(
                        f"{cfg.name} has {stacked[name]} layers in "
                        f"{name}, got {len(tree[name])}")
                setattr(self, name,
                        nn.ModuleList(ParamBlock(b) for b in tree[name]))
            else:
                setattr(self, name, ParamBlock(tree[name]))

    def tree(self) -> dict:
        return {name: ([b.tensors() for b in m]
                       if isinstance(m, nn.ModuleList) else m.tensors())
                for name, m in self.named_children()}


class Weights:
    """An LM's tensors with :class:`DecoderLM`'s access (``w.embed["tok"]``,
    ``w.blocks[i]["attn_wq"]``, ``w.tree()``), as plain tensors: a dict
    per group, a list of dicts for the stacked groups.  What
    ``lm.cast_params`` returns.  A module would wrap each cast in a new
    leaf parameter and cut the autograd graph back to the master
    weights; plain tensors keep it."""

    def __init__(self, tree: dict):
        self._names = sorted(tree)
        for name in self._names:
            setattr(self, name, tree[name])

    def tree(self) -> dict:
        return {name: getattr(self, name) for name in self._names}


def init_params(cfg: ModelConfig, seed: int = 0, max_len: int = 0,
                device=None) -> DecoderLM:
    """Random parameters in ``cfg.param_dtype``, drawn on ``device``
    (default: the CUDA card; ``device="cpu"`` for the host) from a
    ``torch.Generator`` seeded with ``seed``: one generator for the
    whole model, its groups drawn in sorted order and the layers in
    order.  ``max_len`` sizes Whisper's learned positions."""
    dev = resolve_device(device)
    schema = model_schema(cfg, max_len)
    dtype = getattr(torch, cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    stacked = stacked_groups(cfg)
    tree = {}
    for name in sorted(schema):
        if name in stacked:
            layer = {k: (shape[1:], lg[1:], scale)
                     for k, (shape, lg, scale) in schema[name].items()}
            tree[name] = [L.build_params(layer, gen, dtype, dev)
                          for _ in range(stacked[name])]
        else:
            tree[name] = L.build_params(schema[name], gen, dtype, dev)
    return DecoderLM(cfg, tree)


def window_pattern(cfg: ModelConfig) -> list[int]:
    """Per-layer sliding-window size; 0 = global attention."""
    if cfg.local_global:
        return [cfg.local_window if layer % 2 == 0 else 0
                for layer in range(cfg.n_layers)]
    return [cfg.window or 0] * cfg.n_layers


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def apply_decoder_block(cfg: ModelConfig, p, h, positions, window,
                        cache=None, fresh_kv=True):
    x = L.apply_norm(cfg, p, "ln1", h)
    if cfg.attention_impl == "flash" and cache is None:
        # as in the reference: the flash branch takes the config's uniform
        # window, not the per-layer one, and the cached paths never take it
        a, new_cache = L.attention_flash(cfg, p, x, positions,
                                         window=cfg.window)
    else:
        a, new_cache = L.attention(cfg, p, x, positions, window=window,
                                   cache=cache, fresh_kv=fresh_kv)
    if cfg.post_norm:
        a = L.apply_norm(cfg, p, "pn1", a)
    h = h + a
    x = L.apply_norm(cfg, p, "ln2", h)
    if cfg.n_experts:
        m, aux = L.apply_moe(cfg, p, x)
    else:
        m, aux = L.apply_mlp(cfg, p, x), 0.0
    if cfg.post_norm:
        m = L.apply_norm(cfg, p, "pn2", m)
    return h + m, new_cache, aux


def apply_ssm_block(cfg: ModelConfig, p, h, cache=None):
    x = L.apply_norm(cfg, p, "ln1", h)
    y, new_cache = S.mamba2_block(cfg, p, x, cache=cache)
    return h + y, new_cache


def apply_shared_block(cfg: ModelConfig, p, h, positions, cache=None,
                       fresh_kv=True):
    """Zamba2's shared attention + MLP block (plain ``attention``, never
    the flash route, as in the reference)."""
    x = L.apply_norm(cfg, p, "ln1", h)
    a, new_cache = L.attention(cfg, p, x, positions, cache=cache,
                               fresh_kv=fresh_kv)
    h = h + a
    x = L.apply_norm(cfg, p, "ln2", h)
    return h + L.apply_mlp(cfg, p, x), new_cache


def apply_xdec_block(cfg: ModelConfig, p, h, positions, enc_out,
                     cache=None):
    """Whisper decoder block; ``cache`` is None or ``{"self": ring}``."""
    x = L.apply_norm(cfg, p, "ln1", h)
    a, _ = L.attention(cfg, p, x, positions, prefix="attn",
                       cache=None if cache is None else cache["self"])
    h = h + a
    x = L.apply_norm(cfg, p, "ln2", h)
    a, _ = L.attention(cfg, p, x, positions, prefix="xattn", kv_x=enc_out)
    h = h + a
    x = L.apply_norm(cfg, p, "ln3", h)
    h = h + L.apply_mlp(cfg, p, x)
    return h, cache


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params, tokens, positions):
    """Token (and learned position) embeddings in the compute dtype.
    Inside ``parallel.split_model`` with the vocabulary split over the
    model team, a rank looks up the tokens in its rows of the table
    (zeros for the others'), all-reduced over the team."""
    dt = getattr(torch, cfg.dtype)
    tp = P.active()
    if tp is not None and tp.vocab:
        tok = P.leaf("embed", params.embed, "tok").to(dt)
        n = tok.shape[0]
        local = tokens - tp.vocab_span[0]
        inside = (local >= 0) & (local < n)
        h = tp.reduce_from(torch.where(inside[..., None],
                                       tok[local.clamp(0, n - 1)], 0))
    else:
        h = P.leaf("embed", params.embed, "tok").to(dt)[tokens]
    if cfg.name.startswith("gemma"):
        # a 0-d host tensor: rounded to dt like the reference's scale,
        # with no host-to-device copy
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    if cfg.rope_theta == 0 and "pos" in params.embed:
        h = h + P.leaf("embed", params.embed, "pos").to(dt)[positions]
    return h


def _remat(cfg: ModelConfig, h) -> bool:
    """Whether the cache-free forward checkpoints its layers: under
    ``cfg.remat`` when gradients are on and the residual stream carries
    them."""
    return cfg.remat and torch.is_grad_enabled() and h.requires_grad


def _ckpt(fn, *args):
    # the forward draws no random numbers, so there is no RNG state to
    # carry into the recompute
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _run_layers(layer, carry, items, remat: bool, group: int = 0):
    """``carry = layer(*carry, *item)`` over ``items`` in order; with
    ``remat`` each call checkpointed, and with ``group`` > 1 dividing the
    count, each run of ``group`` calls checkpointed around its
    checkpointed layers (the reference's ``_grouped_scan``)."""
    if not remat:
        for item in items:
            carry = layer(*carry, *item)
        return carry

    def run(*c, members):
        for item in members:
            c = _ckpt(layer, *c, *item)
        return c

    if group <= 1 or len(items) % group:
        return run(*carry, members=items)
    for i in range(0, len(items), group):
        carry = _ckpt(partial(run, members=items[i:i + group]), *carry)
    return carry


def encode(cfg: ModelConfig, params: DecoderLM, frames):
    """Whisper's encoder over stub frame embeddings (B, enc_len, d):
    learned positions, bidirectional attention, the final ``efn`` norm."""
    dt = getattr(torch, cfg.dtype)
    h = frames.to(dt) + P.leaf("embed", params.embed, "pos_enc").to(dt)
    positions = torch.arange(h.shape[1], device=h.device)

    def layer(h, p):
        p = P.view("enc", p)
        x = L.apply_norm(cfg, p, "ln1", h)
        a, _ = L.attention(cfg, p, x, positions, causal=False)
        h = h + a
        x = L.apply_norm(cfg, p, "ln2", h)
        return (h + L.apply_mlp(cfg, p, x),)

    (h,) = _run_layers(layer, (h,), [(p,) for p in params.enc],
                       _remat(cfg, h))
    return L.apply_norm(cfg, params.enc_final, "efn", h)


def forward(cfg: ModelConfig, params: DecoderLM, tokens, positions, *,
            caches=None, enc_frames=None, enc_out=None, fresh_kv=True):
    """Token ids -> final hidden states.

    Returns (hidden, caches, aux_loss) as the reference does.  ``caches``
    is None (the cache-free forward) or the tree from :func:`init_cache`,
    written in place and returned; the cached path returns a zero aux
    loss, as the reference's does.  An enc-dec model takes its encoder
    output from ``enc_out``, else from ``enc_frames`` (encoded here),
    else from ``caches["enc_out"]``, in that order; a cached call stores
    it in the cache.  The cache-free forward checkpoints its layers
    under ``cfg.remat`` (see the module's docstring): each decoder,
    Mamba2 or Whisper layer, and each Zamba2 group (the shared block and
    its Mamba2 layers), as the reference does."""
    h = _embed(cfg, params, tokens, positions)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = caches is None and _remat(cfg, h)

    if cfg.enc_dec:
        stored = False
        if enc_out is None:
            if enc_frames is not None:
                enc_out = encode(cfg, params, enc_frames)
            elif caches is not None:
                enc_out, stored = _enc_out_whole(caches["enc_out"]), True
                enc_out = enc_out.to(h.dtype)
            else:
                raise ValueError("enc-dec forward needs frames or enc_out")
        if caches is None:
            (h,) = _run_layers(
                lambda h, p: (apply_xdec_block(
                    cfg, P.view("blocks", p), h, positions, enc_out)[0],),
                (h,), [(p,) for p in params.blocks], remat)
        else:
            for layer, p in enumerate(params.blocks):
                h, _ = apply_xdec_block(
                    cfg, P.view("blocks", p), h, positions, enc_out,
                    cache=layer_cache(caches["layers"], layer))
            if not stored and enc_out is not caches["enc_out"]:
                caches["enc_out"].copy_(_enc_out_block(enc_out))
    elif cfg.family == "ssm":
        if caches is None:
            (h,) = _run_layers(
                lambda h, p: (apply_ssm_block(cfg, P.view("blocks", p),
                                              h)[0],), (h,),
                [(p,) for p in params.blocks], remat)
        else:
            for layer, p in enumerate(params.blocks):
                h, _ = apply_ssm_block(cfg, P.view("blocks", p), h,
                                       cache=layer_cache(caches, layer))
    elif cfg.family == "hybrid":
        per = cfg.shared_every
        groups = [params.blocks[grp * per:(grp + 1) * per]
                  for grp in range(cfg.n_layers // per)]
        if caches is None:
            def group(h, members):
                h, _ = apply_shared_block(cfg, P.view("shared",
                                                      params.shared),
                                          h, positions, fresh_kv=fresh_kv)
                for p in members:
                    h, _ = apply_ssm_block(cfg, P.view("blocks", p), h)
                return (h,)
            # the reference checkpoints each group, not its Mamba2 layers
            (h,) = _run_layers(group, (h,), [(m,) for m in groups], remat)
        else:
            for grp, members in enumerate(groups):
                h, _ = apply_shared_block(
                    cfg, P.view("shared", params.shared), h, positions,
                    cache=layer_cache(caches["shared"], grp),
                    fresh_kv=fresh_kv)
                for j, p in enumerate(members):
                    h, _ = apply_ssm_block(
                        cfg, P.view("blocks", p), h,
                        cache=layer_cache(layer_cache(caches["mamba"], grp),
                                          j))
    else:
        layers = list(zip(params.blocks, window_pattern(cfg)))
        if caches is None:
            def layer(h, aux, p, w):
                # a split step's blocks are gathered here, inside the
                # layer's checkpoint (as in every family's loop above):
                # remat gathers them again
                h, _, a = apply_decoder_block(cfg, P.view("blocks", p), h,
                                              positions, w)
                return h, aux + a
            h, aux = _run_layers(layer, (h, aux), layers, remat,
                                 cfg.remat_group)
        else:
            for layer, (p, w) in enumerate(layers):
                h, _, _ = apply_decoder_block(
                    cfg, P.view("blocks", p), h, positions, w,
                    cache=layer_cache(caches, layer), fresh_kv=fresh_kv)
    h = L.apply_norm(cfg, params.final, "fn", h)
    return h, caches, aux


def _enc_out_whole(t):
    """The stored encoder output as the decoder reads it: whole over the
    width and sequence its cache spec splits (inside a serving
    ``parallel.split_model``), else as it is."""
    tp = P.active()
    return t if tp is None else tp.enc_out_whole(t)


def _enc_out_block(t):
    """The block of an encoder output the cache holds on this rank."""
    tp = P.active()
    return t if tp is None else tp.enc_out_block(t)


def head_weight(params: DecoderLM):
    """The (V_pad, d) table ``lm_head`` multiplies by (``unembed``, else
    the tied ``tok``), as the compute reads it (``parallel.view``: a
    split step's rows of the vocabulary, gathered over the FSDP axis)."""
    return P.leaf("embed", params.embed,
                  "unembed" if "unembed" in params.embed else "tok")


def lm_head(cfg: ModelConfig, params: DecoderLM, h, emb=None):
    """Final hidden -> float32 logits over the padded vocab (padded lanes
    at -1e30), tied embeddings unless the model has ``unembed``.  The
    product is taken in the compute dtype and then widened, as in the
    reference.  ``emb`` is :func:`head_weight`'s table, when the caller
    has it.  Inside ``parallel.split_model`` with the vocabulary split
    over the model team: this rank's lanes only, the padded ones masked
    by their global lane index."""
    if emb is None:
        emb = head_weight(params)
    tp = P.active()
    split = tp is not None and tp.vocab
    if split:
        h = tp.copy_to(h)
    logits = (h @ emb.to(h.dtype).T).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if split:
        lane = torch.arange(*tp.vocab_span, device=logits.device)
        logits = logits.masked_fill(lane >= cfg.vocab, L.NEG_INF)
    elif cfg.vocab_pad != cfg.vocab:
        logits[..., cfg.vocab:] = L.NEG_INF
    return logits


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def cache_width(cfg: ModelConfig, max_len: int) -> int:
    """Ring slots per attention layer: ``max_len``; under a sliding
    window, window + the chunked-prefill segment (a segment is written
    before any of its queries reads, so the ring must hold both); under
    ``local_global`` the widest layer's width."""
    if cfg.local_global:
        widths = [cfg.local_window if layer % 2 == 0 else max_len
                  for layer in range(cfg.n_layers)]
        return max(min(w, max_len) for w in widths)
    if cfg.window:
        return min(max_len, cfg.window + cfg.prefill_chunk)
    return max_len


@dataclass(frozen=True)
class CacheLeaf:
    """A cache leaf's shape and dtype (:func:`cache_shapes`)."""
    shape: tuple
    dtype: torch.dtype


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The tree of :func:`init_cache` as :class:`CacheLeaf`\\ s, no tensor
    made (a dry run's fake tensors would count even meta ones)."""
    dt = getattr(torch, cfg.dtype)

    def rings(n: int) -> dict:
        width = cache_width(cfg, max_len)
        shape = (n, batch, cfg.n_kv, width, cfg.hd)
        return {"k": CacheLeaf(shape, dt), "v": CacheLeaf(shape, dt),
                "pos": CacheLeaf((n, width), torch.int32)}

    def ssm_state(*lead) -> dict:
        shp = S.ssm_cache_shape(cfg, batch)
        return {"conv": CacheLeaf(lead + shp["conv"], dt),
                "h": CacheLeaf(lead + shp["h"], torch.float32)}

    if cfg.family == "ssm":
        return ssm_state(cfg.n_layers)
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.shared_every
        return {"shared": rings(groups),
                "mamba": ssm_state(groups, cfg.shared_every)}
    if cfg.enc_dec:
        return {"layers": {"self": rings(cfg.n_layers)},
                "enc_out": CacheLeaf((batch, cfg.enc_len, cfg.d_model), dt)}
    return rings(cfg.n_layers)


def make_cache(shapes, device) -> dict:
    """A cache of the tree ``shapes`` (:class:`CacheLeaf`\\ s) on
    ``device``: zeros, ``pos = -1`` (an empty slot)."""
    def leaf(name, t):
        if isinstance(t, dict):
            return {k: leaf(k, v) for k, v in t.items()}
        if name == "pos":
            return torch.full(t.shape, -1, dtype=t.dtype, device=device)
        return torch.zeros(t.shape, dtype=t.dtype, device=device)

    return {k: leaf(k, v) for k, v in shapes.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """The serve path's cache on ``device`` (default: the CUDA card), the
    reference's tree, zeros (``pos = -1``: an empty slot):

      * decoders: ``{"k", "v": (n_layers, batch, Hkv, W, hd), "pos":
        (n_layers, W) int32}``, W from :func:`cache_width` (a sliding-
        window model ring-buffers only its window);
      * ssm: ``{"conv": (n_layers, batch, K-1, conv_dim), "h":
        (n_layers, batch, nh, hp, N) float32}``;
      * hybrid: ``{"shared": one ring per group (G, ...), "mamba": the
        ssm state (G, shared_every, ...)}``;
      * enc-dec: ``{"layers": {"self": rings (n_layers, ...)}, "enc_out":
        (batch, enc_len, d)}``.

    K/V, ``conv`` and ``enc_out`` are in the compute dtype."""
    return make_cache(cache_shapes(cfg, batch, max_len),
                      resolve_device(device))


def cache_logical_axes(cfg: ModelConfig) -> dict:
    """The logical-axes tree of :func:`init_cache`'s cache."""
    attn = {"k": ("layers", "batch", "kv", "kv_seq", "none"),
            "v": ("layers", "batch", "kv", "kv_seq", "none"),
            "pos": ("layers", "none")}
    ssm = {"conv": ("layers", "batch", "none", "heads"),
           "h": ("layers", "batch", "heads", "none", "none")}
    if cfg.family == "ssm":
        return ssm
    if cfg.family == "hybrid":
        deep = {"conv": ("layers", "layers", "batch", "none", "heads"),
                "h": ("layers", "layers", "batch", "heads", "none", "none")}
        return {"shared": attn, "mamba": deep}
    if cfg.enc_dec:
        return {"layers": {"self": attn},
                "enc_out": ("batch", "seq", "embed")}
    return attn


def layer_cache(caches: dict, layer: int) -> dict:
    """Views of entry ``layer`` of a stacked cache tree (every leaf indexed
    on its leading axis); writes to them land in the stack."""
    return {name: (layer_cache(t, layer) if isinstance(t, dict)
                   else t[layer])
            for name, t in caches.items()}
