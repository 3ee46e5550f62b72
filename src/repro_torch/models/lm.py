"""Loss evaluation and serving of the LM zoo.

Port of ``repro.models.lm``'s ``Batch``, ``cross_entropy``,
``cast_params``, ``loss_fn``, ``make_prefill`` and ``make_decode_step``:
the cache-free forward of a batch and its mean next-token cross entropy,
and the serve path's prefill (single-shot or chunked) and greedy decode
step over the cache (the KV rings, the Mamba2 state, Whisper's encoder
output), for every family of the zoo.  The train step (gradients,
AdamW, microbatching) and the sharding helpers belong to later slices.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import transformer as T
from .config import ModelConfig


class Batch(NamedTuple):
    tokens: torch.Tensor               # (B, L) integer ids
    targets: torch.Tensor              # (B, L) next-token labels
    frames: torch.Tensor | None = None  # (B, enc_len, d) enc-dec stub input


def cross_entropy(cfg: ModelConfig, params, hidden, targets):
    """Mean next-token cross entropy; taken over sequence chunks of
    ``cfg.loss_chunk`` positions when that divides L (and L is longer),
    so only one chunk's (B, chunk, V) logits are live at a time."""
    B, L, _ = hidden.shape

    def xent(h, t):
        logits = T.lm_head(cfg, params, h)
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, t[..., None].long())[..., 0]
        return torch.sum(lse - picked)

    if cfg.loss_chunk and L % cfg.loss_chunk == 0 and L > cfg.loss_chunk:
        c = cfg.loss_chunk
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(L // c):
            total = total + xent(hidden[:, i * c:(i + 1) * c],
                                 targets[:, i * c:(i + 1) * c])
    else:
        total = xent(hidden, targets)
    return total / (B * L)


def cast_params(cfg: ModelConfig, params: T.DecoderLM) -> T.DecoderLM:
    """The float32 master weights cast to the compute dtype once, before
    the layer loop; a new model (the master stays as it is)."""
    dt = getattr(torch, cfg.dtype)

    def cast(t):
        return t.to(dt) if t.dtype == torch.float32 else t

    return T.DecoderLM(cfg, {
        name: ([{k: cast(v) for k, v in b.items()} for b in group]
               if isinstance(group, list)
               else {k: cast(v) for k, v in group.items()})
        for name, group in params.tree().items()})


def loss_fn(cfg: ModelConfig, params: T.DecoderLM, batch: Batch):
    """(total, {"loss", "aux_loss"}) of one batch, as the reference's
    ``loss_fn``: total = loss + 0.01 * aux."""
    _, L = batch.tokens.shape
    positions = torch.arange(L, device=batch.tokens.device)
    pc = cast_params(cfg, params)
    hidden, _, aux = T.forward(cfg, pc, batch.tokens, positions,
                               enc_frames=batch.frames)
    loss = cross_entropy(cfg, pc, hidden, batch.targets)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux}


def make_train_step(cfg: ModelConfig, *args, **kwargs):
    raise NotImplementedError("make_train_step belongs to the train-step "
                              "slice (train/optim.py, train/loop.py)")


def make_prefill(cfg: ModelConfig, max_len: int):
    """prefill(params, cache, tokens[, frames]) -> (cache, last_logits).

    ``tokens`` (B, L) fill the cache from position 0, which is written in
    place and returned; ``last_logits`` (B, V_pad) float32 are the last
    position's.  With ``cfg.prefill_chunk`` > 0 dividing a longer L, the
    prompt goes through in segments against the cache (chunked prefill,
    the Mamba2 state carried from segment to segment): peak activation
    memory drops from O(L) to O(chunk).  An enc-dec model's prompt is
    never chunked; its ``frames`` (B, enc_len, d) are encoded and the
    encoder output stored in the cache for the decode steps."""

    def prefill(params, cache, tokens, frames=None):
        B, L = tokens.shape
        dev = tokens.device
        ck = cfg.prefill_chunk
        if ck and L > ck and L % ck == 0 and not cfg.enc_dec:
            for start in range(0, L, ck):
                positions = torch.arange(start, start + ck, device=dev)
                hidden, cache, _ = T.forward(
                    cfg, params, tokens[:, start:start + ck], positions,
                    caches=cache, fresh_kv=False)
        else:
            positions = torch.arange(L, device=dev)
            hidden, cache, _ = T.forward(cfg, params, tokens, positions,
                                         caches=cache, enc_frames=frames)
        logits = T.lm_head(cfg, params, hidden[:, -1:])
        return cache, logits[:, 0]

    return prefill


def make_decode_step(cfg: ModelConfig):
    """decode(params, cache, token (B,), step) -> (cache, next (B,)).

    ``step`` is the new token's position: a one-element tensor on the
    cache's device (no host copy, so a decode loop never waits on the
    card), or an int.  The cache is written in place and returned;
    ``next`` is the greedy token, in ``token``'s dtype."""

    def decode(params, cache, token, step):
        positions = (step.reshape(1) if torch.is_tensor(step)
                     else torch.tensor([int(step)], device=token.device))
        hidden, cache, _ = T.forward(cfg, params, token[:, None], positions,
                                     caches=cache)
        logits = T.lm_head(cfg, params, hidden)
        nxt = torch.argmax(logits[:, 0], dim=-1).to(token.dtype)
        return cache, nxt

    return decode
