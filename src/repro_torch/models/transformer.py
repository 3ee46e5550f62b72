"""Model assembly of the LM zoo: the decoder-only families, with and
without the serve path's KV cache.

Port of ``repro.models.transformer`` for the dense, MoE and vlm
families.  The reference keeps its parameters as a pytree with the
layers stacked for ``lax.scan``; the port keeps them in a
:class:`DecoderLM` module whose ``blocks`` is a ``ModuleList`` of one
:class:`ParamBlock` per layer, each holding the schema's names as its
parameters, and runs the layers in a Python loop.  ``forward``,
``lm_head``, ``init_params`` and ``init_cache`` keep the reference's
names.

The cache is the reference's stacked tree, ``{"k", "v": (n_layers, B,
Hkv, W, hd), "pos": (n_layers, W)}``; each layer writes its slice in
place, so the cache is never double-buffered (the reference's
``_serve_loop`` carries it through a ``fori_loop`` for the same end).

The SSM, hybrid and enc-dec families belong to later slices and raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from . import layers as L
from .config import ModelConfig

_FAMILY_SLICE = {
    "ssm": "the SSM slice (models/ssm.py, Mamba2 blocks)",
    "hybrid": "the hybrid slice (Zamba2's shared attention over Mamba2)",
    "audio": "the Whisper slice (encoder, cross-attention)",
}


def _check_family(cfg: ModelConfig) -> None:
    fam = "audio" if cfg.enc_dec else cfg.family
    if fam in _FAMILY_SLICE:
        raise NotImplementedError(
            f"{cfg.name}: the {fam} family belongs to {_FAMILY_SLICE[fam]}; "
            f"the port runs the dense, MoE and vlm decoders")


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


def model_schema(cfg: ModelConfig, max_len: int = 0):
    """The reference's schema tree for the decoder-only families, with
    ``blocks`` stacked over the layers."""
    _check_family(cfg)
    d, V = cfg.d_model, cfg.vocab_pad
    tree = {
        "embed": {"tok": ((V, d), ("vocab", "embed"), 1e-2)},
        "final": L.norm_schema(cfg, "fn"),
    }
    if not cfg.tie_embeddings:
        tree["embed"]["unembed"] = ((V, d), ("vocab", "embed"), 1e-2)
    if cfg.rope_theta == 0:  # learned absolute positions
        tree["embed"]["pos"] = ((max_len, d), ("none", "embed"), 1e-2)
    tree["blocks"] = L.stack_schema(decoder_block_schema(cfg), cfg.n_layers)
    return tree


class ParamBlock(nn.Module):
    """A flat group of named tensors (one schema), read as a mapping:
    ``p["attn_wq"]``, ``"attn_qnorm" in p``.  The tensors are parameters
    without gradients: the port evaluates the loss and serves, and the
    train step that differentiates it is a later slice."""

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
    """Parameters of a decoder-only LM: ``embed`` (tok, unembed, pos),
    ``final`` (the final norm) and ``blocks`` (one per layer).
    ``tree`` is ``{"embed": {...}, "final": {...}, "blocks": [{...} per
    layer]}``."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        _check_family(cfg)
        if len(tree["blocks"]) != cfg.n_layers:
            raise ValueError(f"{cfg.name} has {cfg.n_layers} layers, got "
                             f"{len(tree['blocks'])} blocks")
        self.embed = ParamBlock(tree["embed"])
        self.final = ParamBlock(tree["final"])
        self.blocks = nn.ModuleList(ParamBlock(b) for b in tree["blocks"])

    def tree(self) -> dict:
        return {"embed": self.embed.tensors(), "final": self.final.tensors(),
                "blocks": [b.tensors() for b in self.blocks]}


def init_params(cfg: ModelConfig, seed: int = 0, max_len: int = 0,
                device=None) -> DecoderLM:
    """Random parameters in ``cfg.param_dtype``, drawn on ``device``
    (default: the CUDA card; ``device="cpu"`` for the host) from a
    ``torch.Generator`` seeded with ``seed``: one generator for the
    whole model, its groups drawn in sorted order and the layers in
    order."""
    dev = resolve_device(device)
    schema = model_schema(cfg, max_len)
    dtype = getattr(torch, cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    block = {name: (shape[1:], lg[1:], scale)
             for name, (shape, lg, scale) in schema["blocks"].items()}
    tree = {}
    for name in sorted(schema):
        if name == "blocks":
            tree[name] = [L.build_params(block, gen, dtype, dev)
                          for _ in range(cfg.n_layers)]
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


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params, tokens, positions):
    dt = getattr(torch, cfg.dtype)
    h = params.embed["tok"].to(dt)[tokens]
    if cfg.name.startswith("gemma"):
        # a 0-d host tensor: rounded to dt like the reference's scale,
        # with no host-to-device copy
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    if cfg.rope_theta == 0 and "pos" in params.embed:
        h = h + params.embed["pos"].to(dt)[positions]
    return h


def forward(cfg: ModelConfig, params: DecoderLM, tokens, positions, *,
            caches=None, fresh_kv=True):
    """Token ids -> final hidden states.

    Returns (hidden, caches, aux_loss) as the reference does.  ``caches``
    is None (the cache-free forward) or the tree from :func:`init_cache`,
    written in place and returned; the cached path returns a zero aux
    loss, as the reference's does.  The non-decoder families raise
    ``NotImplementedError``."""
    _check_family(cfg)
    h = _embed(cfg, params, tokens, positions)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for layer, (p, w) in enumerate(zip(params.blocks, window_pattern(cfg))):
        if caches is None:
            h, _, a = apply_decoder_block(cfg, p, h, positions, w)
            aux = aux + a
        else:
            h, _, _ = apply_decoder_block(
                cfg, p, h, positions, w, cache=layer_cache(caches, layer),
                fresh_kv=fresh_kv)
    h = L.apply_norm(cfg, params.final, "fn", h)
    return h, caches, aux


def lm_head(cfg: ModelConfig, params: DecoderLM, h):
    """Final hidden -> float32 logits over the padded vocab (padded lanes
    at -1e30), tied embeddings unless the model has ``unembed``.  The
    product is taken in the compute dtype and then widened, as in the
    reference."""
    emb = params.embed["unembed" if "unembed" in params.embed else "tok"]
    logits = (h @ emb.to(h.dtype).T).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.vocab_pad != cfg.vocab:
        logits[..., cfg.vocab:] = L.NEG_INF
    return logits


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def cache_width(cfg: ModelConfig, max_len: int) -> int:
    """Ring slots per layer: ``max_len``; under a sliding window, window +
    the chunked-prefill segment (a segment is written before any of its
    queries reads, so the ring must hold both); under ``local_global``
    the widest layer's width."""
    if cfg.local_global:
        widths = [cfg.local_window if layer % 2 == 0 else max_len
                  for layer in range(cfg.n_layers)]
        return max(min(w, max_len) for w in widths)
    if cfg.window:
        return min(max_len, cfg.window + cfg.prefill_chunk)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """The serve path's cache on ``device`` (default: the CUDA card):
    ``{"k", "v": zeros (n_layers, batch, Hkv, W, hd) in the compute
    dtype, "pos": (n_layers, W) int32 of -1 (empty)}``, W from
    :func:`cache_width`.  A sliding-window model ring-buffers only its
    window, which is what makes long decodes fit."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    width = cache_width(cfg, max_len)
    shape = (cfg.n_layers, batch, cfg.n_kv, width, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "pos": torch.full((cfg.n_layers, width), -1, dtype=torch.int32,
                              device=dev)}


def layer_cache(caches, layer: int) -> dict:
    """Views of one layer's ring in the stacked cache; writes to them land
    in the stack."""
    return {name: caches[name][layer] for name in ("k", "v", "pos")}
