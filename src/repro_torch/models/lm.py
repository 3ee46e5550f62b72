"""Loss, training and serving of the LM zoo.

Port of ``repro.models.lm``'s ``Batch``, ``cross_entropy``,
``cast_params``, ``loss_fn``, ``TrainState``, ``make_train_step``,
``make_prefill`` and ``make_decode_step``: the cache-free forward of a
batch and its mean next-token cross entropy; the train step (gradients
accumulated over micro-batches, AdamW); and the serve path's prefill
(single-shot or chunked) and greedy decode step over the cache (the KV
rings, the Mamba2 state, Whisper's encoder output), for every family of
the zoo.  The sharding helpers (``*_shardings``) belong to the
multi-rank training slice.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..train.optim import AdamW, accumulate_gradients
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
        # with gradients, each chunk is checkpointed (as the reference's
        # scan body is): its logits are recomputed in the backward
        # instead of all L / c chunks' staying live
        grad = torch.is_grad_enabled() and hidden.requires_grad
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(L // c):
            h, t = hidden[:, i * c:(i + 1) * c], targets[:, i * c:(i + 1) * c]
            total = total + (checkpoint(xent, h, t, use_reentrant=False,
                                        preserve_rng_state=False)
                             if grad else xent(h, t))
    else:
        total = xent(hidden, targets)
    return total / (B * L)


def cast_params(cfg: ModelConfig, params) -> T.Weights:
    """The float32 master weights cast to the compute dtype once, before
    the layer loop, as a :class:`~transformer.Weights` of plain tensors:
    the casts stay on the autograd graph of the master (a float32 compute
    dtype casts nothing, so no weight is copied)."""
    dt = getattr(torch, cfg.dtype)

    def cast(t):
        return t.to(dt) if t.dtype == torch.float32 else t

    return T.Weights({
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


class TrainState(NamedTuple):
    params: T.DecoderLM          # float32 master weights, trainable leaves
    opt: object                  # the optimizer's state (AdamWState)
    step: torch.Tensor           # () int32, on the parameters' device


def init_train_state(params: T.DecoderLM, optimizer) -> TrainState:
    """A train state at step 0 around ``params``, whose tensors become
    trainable leaves (``requires_grad_()``, in place)."""
    params.requires_grad_(True)
    dev = next(params.parameters()).device
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=dev))


def make_train_step(cfg: ModelConfig, optimizer: AdamW, lr_schedule,
                    n_micro: int | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the
    gradients of :func:`loss_fn` averaged over ``n_micro`` equal splits of
    the batch (default ``cfg.n_micro``), then the optimizer's update at
    ``lr_schedule(state.step)``.  The parameters are updated in place
    (the reference donates its state to the jitted step); metrics
    ``loss``, ``aux_loss``, ``grad_norm`` and ``lr`` are device scalars,
    the loss and aux of the last micro-batch, as the reference's."""
    n_micro = n_micro if n_micro is not None else cfg.n_micro

    def train_step(state: TrainState, batch: Batch):
        (total, aux), grads = accumulate_gradients(
            partial(loss_fn, cfg), state.params, batch, n_micro)
        lr = lr_schedule(state.step)
        _, new_opt, gnorm = optimizer.update(grads, state.opt, state.params,
                                             lr=lr)
        metrics = {"loss": aux["loss"], "aux_loss": aux["aux_loss"],
                   "grad_norm": gnorm, "lr": lr}
        return TrainState(state.params, new_opt, state.step + 1), metrics

    return train_step


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

    @torch.no_grad()
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

    @torch.no_grad()
    def decode(params, cache, token, step):
        positions = (step.reshape(1) if torch.is_tensor(step)
                     else torch.tensor([int(step)], device=token.device))
        hidden, cache, _ = T.forward(cfg, params, token[:, None], positions,
                                     caches=cache)
        logits = T.lm_head(cfg, params, hidden)
        nxt = torch.argmax(logits[:, 0], dim=-1).to(token.dtype)
        return cache, nxt

    return decode
