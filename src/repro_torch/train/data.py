"""Deterministic, resumable synthetic data pipeline.

Port of ``repro.train.data``.  The pipeline is a stateless function
``step -> batch``: a restarted or replaced worker reproduces exactly the
batch of the step it joins at, with no coordination, and the checkpoint
records only the step.

  * ``SyntheticLM``: token streams with a Zipf head marginal and a
    first-order Markov structure, so the loss can fall.
  * ``SyntheticFrames``: stub audio frame embeddings (Whisper's frontend
    is a stub).

``batch_at`` and ``frames_at`` draw with numpy from
``SeedSequence([seed, step])``, as the reference does, so their tokens,
targets and frames (after the dtype cast) are the reference's bit for
bit.  The reference's threefry ``jax_batch_at`` has no torch
counterpart; ``device_batch_at`` keeps its structure (Zipf head, Markov
shift, shifted targets) with a ``torch.Generator`` on the device, not its
bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..models.lm import Batch


@dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_order: int = 1

    def batch_at(self, step: int, device=None) -> Batch:
        """The batch of ``step`` on ``device`` (default: the CUDA card):
        drawn on the host with numpy, copied once."""
        dev = resolve_device(device)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, int(step)]))
        B, L, V = self.global_batch, self.seq_len, self.vocab
        # Zipf marginal over a smallish head + markov next-token bias
        head = min(V, 1024)
        ranks = np.arange(1, head + 1)
        pz = 1.0 / ranks
        pz /= pz.sum()
        base = rng.choice(head, size=(B, L), p=pz).astype(np.int32)
        # markov: with prob .5 next token = f(prev) (learnable structure)
        shift = (base[:, :-1] * 31 + 7) % V
        coin = rng.random((B, L - 1)) < 0.5
        tokens = base.copy()
        tokens[:, 1:] = np.where(coin, shift % V, base[:, 1:])
        targets = np.roll(tokens, -1, axis=1)
        targets[:, -1] = 0
        return Batch(tokens=torch.as_tensor(tokens, device=dev),
                     targets=torch.as_tensor(targets, device=dev),
                     frames=None)

    def device_batch_at(self, step: int, device=None) -> Batch:
        """The same structure drawn on ``device`` from a
        ``torch.Generator`` seeded with (seed, step): Zipf head tokens, a
        fair coin per position choosing the Markov shift, the targets
        shifted by one with a final 0."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(
            (int(self.seed) << 32) + int(step))
        B, L, V = self.global_batch, self.seq_len, self.vocab
        head = min(V, 1024)
        pz = 1.0 / torch.arange(1, head + 1, dtype=torch.float32, device=dev)
        base = torch.multinomial(pz, B * L, replacement=True,
                                 generator=gen).reshape(B, L).to(torch.int32)
        shift = (base * 31 + 7) % V
        coin = torch.rand((B, L), generator=gen, device=dev) < 0.5
        tokens = torch.where(coin, shift, base)
        targets = torch.roll(tokens, -1, dims=1)
        targets[:, -1] = 0
        return Batch(tokens=tokens, targets=targets, frames=None)


@dataclass(frozen=True)
class SyntheticFrames:
    """Stub modality frontend: precomputed frame embeddings."""
    enc_len: int
    d_model: int
    global_batch: int
    seed: int = 0

    def frames_at(self, step: int, dtype=torch.bfloat16, device=None):
        dev = resolve_device(device)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed + 77, int(step)]))
        f = rng.standard_normal(
            (self.global_batch, self.enc_len, self.d_model)) * 0.1
        # through float32, as the reference's float64 draw reaches the
        # device (JAX canonicalises it to float32 before the cast)
        return torch.as_tensor(f.astype(np.float32), device=dev).to(dtype)


def make_source(cfg, seq_len: int, global_batch: int, seed: int = 0,
                device=None):
    """``batch_at(step) -> Batch`` on ``device`` for ``cfg``: the token
    source, with an enc-dec model's frames in its compute dtype."""
    dev = resolve_device(device)
    lm_src = SyntheticLM(cfg.vocab, seq_len, global_batch, seed)
    if cfg.enc_dec:
        fr_src = SyntheticFrames(cfg.enc_len, cfg.d_model, global_batch, seed)
        dt = getattr(torch, cfg.dtype)

        def batch_at(step):
            b = lm_src.batch_at(step, dev)
            return Batch(tokens=b.tokens, targets=b.targets,
                         frames=fr_src.frames_at(step, dt, dev))
        return batch_at
    return lambda step: lm_src.batch_at(step, dev)
