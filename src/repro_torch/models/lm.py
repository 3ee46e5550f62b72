"""Loss, training and serving of the LM zoo.

Port of ``repro.models.lm``'s ``Batch``, ``cross_entropy``,
``cast_params``, ``loss_fn``, ``TrainState``, ``make_train_step``,
``make_prefill`` and ``make_decode_step``: the cache-free forward of a
batch and its mean next-token cross entropy; the train step (gradients
accumulated over micro-batches, AdamW); and the serve path's prefill
(single-shot or chunked) and greedy decode step over the cache (the KV
rings, the Mamba2 state, Whisper's encoder output), for every family of
the zoo.

On a mesh of ranks (``launch.mesh.Mesh``): the spec trees of the
parameters, the optimizer state, the serve cache and the batch
(``param_shardings``, ``opt_shardings``, ``cache_shardings``,
``batch_shardings``, from the config's logical rules), each rank's
blocks of a tree (``shard_tree``, ``shard_params_``) and the whole tree
back (``gather_tree``, for checkpoints and tests), the sharded train
step (``make_train_step(..., mesh=)``): every family splits each layer
over the model team (``models.parallel``), and prefill and decode on a
mesh (``make_prefill`` / ``make_decode_step`` with ``mesh=``): each rank
its blocks of the parameters and of the cache (``init_cache_blocks``),
its rows of the tokens, its block of the logits and its rows of the next
token, as one device of the reference's sharded program
(``serve_shardings``).
"""
from __future__ import annotations

import contextlib
import math
from functools import partial
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..train.optim import AdamW, accumulate_gradients, as_tree
from . import layers as Lyr
from . import parallel as P
from . import transformer as T
from .config import ModelConfig, logical_to_spec, spec_axes, tree_shardings


class Batch(NamedTuple):
    tokens: torch.Tensor               # (B, L) integer ids
    targets: torch.Tensor              # (B, L) next-token labels
    frames: torch.Tensor | None = None  # (B, enc_len, d) enc-dec stub input


def cross_entropy(cfg: ModelConfig, params, hidden, targets):
    """Mean next-token cross entropy; taken over sequence chunks of
    ``cfg.loss_chunk`` positions when that divides L (and L is longer),
    so only one chunk's (B, chunk, V) logits are live at a time.  Inside
    ``parallel.split_model`` with the vocabulary split over the model
    team, each rank holds its lanes of the logits (:func:`_xent_split`);
    the head's table is gathered once for every chunk."""
    B, L, _ = hidden.shape
    emb = T.head_weight(params)
    tp = P.active()
    split = tp is not None and tp.vocab

    def xent(h, t):
        logits = T.lm_head(cfg, params, h, emb)
        if split:
            return _xent_split(tp, logits, t)
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


def _xent_split(tp, logits, targets):
    """The summed cross entropy from this rank's lanes of the logits: the
    row maximum all-reduced (max) over the model team, then the rows'
    sums of exponentials and the target's logit (from the rank whose lanes
    hold it) in one all-reduce.  A rank whose lanes are all padding adds
    exp(-1e30 - max) = 0 and no target."""
    n = logits.shape[-1]
    local = targets.long() - tp.vocab_span[0]
    inside = (local >= 0) & (local < n)
    mx = tp.pmax(torch.amax(logits.detach(), dim=-1))
    picked = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    sums = tp.reduce_from(torch.stack([
        torch.sum(torch.exp(logits - mx[..., None]), dim=-1),
        torch.where(inside, picked, 0.0)]))
    return torch.sum(torch.log(sums[0]) + mx - sums[1])


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
                    n_micro: int | None = None, *, mesh=None, specs=None,
                    max_len: int = 0):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the
    gradients of :func:`loss_fn` averaged over ``n_micro`` equal splits of
    the batch (default ``cfg.n_micro``), then the optimizer's update at
    ``lr_schedule(state.step)``.  The parameters are updated in place
    (the reference donates its state to the jitted step); metrics
    ``loss``, ``aux_loss``, ``grad_norm`` and ``lr`` are device scalars,
    the loss and aux of the last micro-batch, as the reference's.

    With a ``mesh`` the state holds this rank's blocks under ``specs``
    (default :func:`param_shardings` at ``max_len``) and every rank gets
    the whole global batch; see :func:`_sharded_step`."""
    n_micro = n_micro if n_micro is not None else cfg.n_micro
    if mesh is not None:
        if specs is None:
            specs = param_shardings(cfg, mesh, max_len)
        return partial(_sharded_step, cfg, optimizer, lr_schedule, n_micro,
                       mesh, specs)

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


def _sharded_step(cfg: ModelConfig, optimizer, lr_schedule, n_micro: int,
                  mesh, specs, state: TrainState, batch: Batch):
    """One train step on ``mesh``, computing what the reference computes
    on that mesh: :func:`sharded_grads`, then the optimizer's update of
    this rank's blocks of the parameters and its moments, with the global
    norm counted once per element."""
    loss, aux_loss, grads = sharded_grads(cfg, mesh, specs, state.params,
                                          batch, n_micro)
    lr = lr_schedule(state.step)
    _, new_opt, gnorm = optimizer.update(grads, state.opt, state.params,
                                         lr=lr, mesh=mesh, specs=specs)
    metrics = {"loss": loss, "aux_loss": aux_loss, "grad_norm": gnorm,
               "lr": lr}
    return TrainState(state.params, new_opt, state.step + 1), metrics


def sharded_grads(cfg: ModelConfig, mesh, specs, params, batch: Batch,
                  n_micro: int):
    """(loss, aux_loss, grads) of one step on ``mesh``: ``params`` hold
    this rank's blocks under ``specs`` and ``grads`` come back as blocks,
    the float32 gradients of the batch team's mean loss.

      * the global batch splits into ``n_micro`` contiguous micro-batches
        of B_m rows; rank r of the batch team (D ranks over the batch
        rule's axes) takes rows [r B_m / D, (r + 1) B_m / D) of each.  If
        D does not divide B_m, or the MoE's tokens or capacity would not
        split per shard, every rank takes all the rows (the reference's
        fallback to replication) and dispatches the team's token blocks
        itself; the MoE dispatches per shard either way
        (``layers.batch_shards``);
      * the forward and backward run inside ``parallel.split_model``,
        each layer's blocks gathered over the FSDP axis as it runs and
        its compute split over the model team; a block's gradient comes
        back summed over the axes its leaf was gathered over, then over
        the rest of the batch team, and divided by D.

    ``loss`` and ``aux_loss`` are the last micro-batch's, averaged over
    the batch team when the rows are split."""
    axes = Lyr.batch_axes(cfg, mesh)
    team, n_team = mesh.key(axes), mesh.axes_size(axes)
    b, length = batch.tokens.shape
    b_micro = b // n_micro
    rows = (b_micro % n_team == 0
            and Lyr.moe_shardable(cfg, b_micro * length, n_team))
    local = batch
    if rows and n_team > 1:
        r = mesh.axes_index(team)

        def my_rows(x):     # rank r's rows of each micro-batch, in order
            rest = tuple(x.shape[1:])
            return x.reshape((n_micro, n_team, -1) + rest)[:, r].reshape(
                (-1,) + rest)
        local = Batch(*(None if x is None else my_rows(x) for x in batch))
    with Lyr.batch_shards(mesh, rows), P.split_model(cfg, mesh, specs):
        (_, aux), grads = accumulate_gradients(
            partial(loss_fn, cfg), params, local, n_micro)
    _replace_leaves(lambda g, spec: _team_mean_rest(
        g, spec, mesh, team, n_team), grads, specs)
    loss, aux_loss = aux["loss"], aux["aux_loss"]
    if rows and n_team > 1:
        both = mesh.psum(torch.stack([loss, aux_loss]), team) / n_team
        loss, aux_loss = both[0], both[1]
    return loss, aux_loss, grads


def _replace_leaves(fn, tree, specs) -> None:
    """Each leaf of a tree of dicts and lists replaced, in place, by
    ``fn(leaf, spec)``."""
    for k in (sorted(tree) if isinstance(tree, dict) else range(len(tree))):
        if isinstance(tree[k], (dict, list)):
            _replace_leaves(fn, tree[k], specs[k])
        else:
            tree[k] = fn(tree[k], specs[k])


def _team_mean_rest(g, spec, mesh, team, n_team: int):
    """The mean over the batch team of a block's gradient already summed
    over the axes its leaf was gathered over (those of ``spec``): summed
    over the team's other axes, divided by its size."""
    used = {a for entry in spec for a in spec_axes(entry)}
    rest = tuple(a for a in team if a not in used)
    if rest and mesh.axes_size(rest) > 1:
        g = mesh.psum(g, rest)
    return g / n_team


def make_prefill(cfg: ModelConfig, max_len: int, *, mesh=None, specs=None,
                 batch: int | None = None):
    """prefill(params, cache, tokens[, frames]) -> (cache, last_logits).

    ``tokens`` (B, L) fill the cache from position 0, which is written in
    place and returned; ``last_logits`` (B, V_pad) float32 are the last
    position's.  With ``cfg.prefill_chunk`` > 0 dividing a longer L, the
    prompt goes through in segments against the cache (chunked prefill,
    the Mamba2 state carried from segment to segment): peak activation
    memory drops from O(L) to O(chunk).  An enc-dec model's prompt is
    never chunked; its ``frames`` (B, enc_len, d) are encoded and the
    encoder output stored in the cache for the decode steps.

    With a ``mesh`` (and the global ``batch``, which the blocks alone do
    not tell): ``params`` hold this rank's blocks under ``specs``
    (default :func:`param_shardings` at ``max_len``), ``cache`` its
    blocks under :func:`cache_shardings` at ``batch`` and ``max_len``,
    ``tokens`` its rows and ``frames`` its block, as
    :func:`serve_shardings` lays them out; ``last_logits`` come back as
    its block under ``("batch", "vocab")``.  Every family splits each
    layer over the model team (``models.parallel``) as the train step
    does, the cached attention and the Mamba2 block on the cache's
    blocks."""

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

    if mesh is None:
        return prefill
    on = _MeshServe(cfg, mesh, specs, batch, max_len)

    @torch.no_grad()
    def sharded(params, cache, tokens, frames=None):
        with on.serving(cache, tokens):
            if frames is not None:
                frames = mesh.gather(frames, on.frames_spec)
            return prefill(params, cache, tokens, frames)

    return sharded


def make_decode_step(cfg: ModelConfig, *, mesh=None, specs=None,
                     batch: int | None = None):
    """decode(params, cache, token (B,), step) -> (cache, next (B,)).

    ``step`` is the new token's position: a one-element tensor on the
    cache's device (no host copy, so a decode loop never waits on the
    card), or an int.  The cache is written in place and returned;
    ``next`` is the greedy token, in ``token``'s dtype.

    With a ``mesh`` and the global ``batch``, as :func:`make_prefill`
    (``specs`` default to :func:`param_shardings` at the ring's width):
    ``token`` and ``next`` are this rank's rows; where the vocabulary
    splits over the model team the greedy token is the team's maximum,
    the smallest lane among equal maxima (``argmax``'s rule)."""

    @torch.no_grad()
    def decode(params, cache, token, step):
        positions = (step.reshape(1) if torch.is_tensor(step)
                     else torch.tensor([int(step)], device=token.device))
        hidden, cache, _ = T.forward(cfg, params, token[:, None], positions,
                                     caches=cache)
        logits = T.lm_head(cfg, params, hidden)
        nxt = _greedy(logits[:, 0]).to(token.dtype)
        return cache, nxt

    if mesh is None:
        return decode
    on = _MeshServe(cfg, mesh, specs, batch, None)

    @torch.no_grad()
    def sharded(params, cache, token, step):
        with on.serving(cache, token):
            return decode(params, cache, token, step)

    return sharded


def _greedy(logits):
    """``argmax`` over the last dim; inside ``parallel.split_model`` with
    the vocabulary split, over the team's lanes: the maximum over the
    team, then the smallest global lane holding it."""
    tp = P.active()
    at = torch.argmax(logits, dim=-1)
    if tp is None or not tp.vocab:
        return at
    best = torch.gather(logits, -1, at[..., None])[..., 0]
    top = tp.pmax(best)
    lane = torch.where(best == top, at + tp.vocab_span[0],
                       torch.iinfo(torch.int64).max)
    return tp.pmin(lane)


def _ring_width(cache) -> int:
    """The slots of the cache's attention rings (``pos`` is whole on
    every rank), 0 for a cache without one (Mamba2)."""
    for name, t in cache.items():
        if name == "pos":
            return int(t.shape[-1])
        if isinstance(t, dict):
            w = _ring_width(t)
            if w:
                return w
    return 0


class _MeshServe:
    """What prefill and decode on ``mesh`` need around each call: the
    parameters' specs, the cache's (per ring width), the rows of the
    global ``batch`` this rank holds, and whether the MoE dispatches per
    shard of the batch team (the tokens' rows split over all of it) or
    every rank dispatches the team's blocks (the rows replicated).  A
    layout the split route cannot honour raises: the rows split over a
    part of the batch team under an MoE, a cache whose blocks are not
    the specs'."""

    def __init__(self, cfg: ModelConfig, mesh, specs, batch, max_len):
        if batch is None:
            raise ValueError("serving on a mesh needs the global batch "
                             "(batch=): a rank's rows do not tell it")
        self.cfg, self.mesh, self.batch = cfg, mesh, int(batch)
        self.max_len = max_len
        self.specs = specs
        lay = serve_shardings(cfg, mesh, self.batch)
        self.frames_spec = ((None,) + tuple(lay["frames"][1:])
                            if lay["frames"] is not None else None)
        axes = spec_axes(lay["tokens"][0])
        n = mesh.axes_size(axes)
        self.rows = self.batch // n
        team = Lyr.batch_axes(cfg, mesh)
        self.rows_sharded = n > 1
        if self.rows_sharded and set(axes) != set(team) and cfg.n_experts:
            raise ValueError(
                f"the batch of {self.batch} rows splits over {axes}, part "
                f"of the MoE's dispatch team {team}: no per-shard dispatch "
                f"honours that")
        self._caches: dict = {}

    def _cache_layout(self, width: int):
        if width not in self._caches:
            specs = cache_shardings(self.cfg, self.mesh, self.batch, width)
            whole = T.cache_shapes(self.cfg, self.batch, width)
            blocks = map_with_specs(
                lambda t, s: block_shape(t.shape, s, self.mesh), whole,
                specs)
            self._caches[width] = (specs, blocks)
        return self._caches[width]

    @contextlib.contextmanager
    def serving(self, cache, tokens):
        if tokens.shape[0] != self.rows:
            raise ValueError(f"this rank holds {self.rows} of the "
                             f"{self.batch} rows; got {tokens.shape[0]}")
        width = (self.max_len if self.max_len is not None
                 else _ring_width(cache))
        cache_specs, blocks = self._cache_layout(width)
        got = map_with_specs(lambda t, s: tuple(t.shape), cache,
                             cache_specs)
        if got != blocks:
            raise ValueError(f"the cache's blocks {got} are not this "
                             f"rank's blocks {blocks} under "
                             f"cache_shardings")
        specs = self.specs
        if specs is None:
            specs = self.specs = param_shardings(self.cfg, self.mesh, width)
        with Lyr.batch_shards(self.mesh, self.rows_sharded), \
                P.split_model(self.cfg, self.mesh, specs, cache_specs):
            yield


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def param_shardings(cfg: ModelConfig, mesh, max_len: int = 0) -> dict:
    """The parameters' specs on ``mesh`` from the config's rules, as a
    tree beside :meth:`DecoderLM.tree` (a list of per-layer dicts for the
    stacked groups, each layer's spec the reference's stacked spec less
    its leading ``"layers"`` entry, which never takes an axis)."""
    rules = cfg.rules()
    schema = T.model_schema(cfg, max_len)
    stacked = T.stacked_groups(cfg)
    out = {}
    for group, entries in schema.items():
        specs = {k: logical_to_spec(lg, shape, mesh, rules)
                 for k, (shape, lg, _) in entries.items()}
        if group in stacked:
            out[group] = [{k: s[1:] for k, s in specs.items()}
                          for _ in range(stacked[group])]
        else:
            out[group] = specs
    return out


def opt_shardings(cfg: ModelConfig, mesh, optimizer, max_len: int = 0):
    """The optimizer state's specs: the moments as their parameters, the
    step counter replicated (``()``); SGDM's ``v`` is ``{}``."""
    ps = param_shardings(cfg, mesh, max_len)
    probe = optimizer.init({"x": torch.zeros(1)})
    return type(probe)(step=(), m=ps, v=ps if probe.v else {})


def cache_shardings(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """The serve cache's specs, a tree beside :func:`T.init_cache`'s."""
    shapes = T.cache_shapes(cfg, batch, max_len)
    return tree_shardings(T.cache_logical_axes(cfg), shapes, mesh,
                          cfg.rules())


def serve_shardings(cfg: ModelConfig, mesh, batch: int,
                    max_len: int | None = None) -> dict:
    """The specs of prefill's and decode's inputs and outputs at a global
    ``batch`` and cache ``max_len``, as the reference's dry run jits
    them: ``tokens`` (B, L) under ``("batch", "seq")``, ``frames`` (B,
    enc_len, d) under ``("batch", "seq", "embed")`` (None but for an
    enc-dec model), ``logits`` (B, V_pad) under ``("batch", "vocab")``,
    ``token`` (B,) under ``("batch",)``, and, given ``max_len``, the
    ``cache`` (:func:`cache_shardings`)."""
    rules = cfg.rules()
    big = 1 << 30
    out = {
        "tokens": logical_to_spec(("batch", "seq"), (batch, big), mesh,
                                  rules),
        "frames": (logical_to_spec(("batch", "seq", "embed"),
                                   (batch, cfg.enc_len, cfg.d_model), mesh,
                                   rules) if cfg.enc_dec else None),
        "logits": logical_to_spec(("batch", "vocab"),
                                  (batch, cfg.vocab_pad), mesh, rules),
        "token": logical_to_spec(("batch",), (batch,), mesh, rules),
    }
    if max_len is not None:
        out["cache"] = cache_shardings(cfg, mesh, batch, max_len)
    return out


def block_shape(shape, spec, mesh) -> tuple:
    """A rank's block of a tensor of ``shape`` under ``spec``."""
    return tuple(n // math.prod(mesh.shape[a] for a in spec_axes(e))
                 for n, e in zip(shape, spec))


def init_cache_blocks(cfg: ModelConfig, mesh, batch: int, max_len: int,
                      device=None):
    """This rank's blocks of :func:`transformer.init_cache` at a global
    ``batch`` under :func:`cache_shardings`, made as blocks (the whole
    cache is never built): zeros, ``pos = -1``."""
    whole = T.cache_shapes(cfg, batch, max_len)
    specs = cache_shardings(cfg, mesh, batch, max_len)
    blocks = map_with_specs(
        lambda t, s: T.CacheLeaf(block_shape(t.shape, s, mesh), t.dtype),
        whole, specs)
    return T.make_cache(blocks, resolve_device(device))


def batch_shardings(cfg: ModelConfig, mesh) -> Batch:
    """The batch's specs: rows over the batch rule's axes."""
    rules = cfg.rules()
    big = 1 << 30
    tok = logical_to_spec(("batch", "seq"), (big, big), mesh, rules)
    fr = (logical_to_spec(("batch", "seq", "embed"), (big, big, big), mesh,
                          rules) if cfg.enc_dec else None)
    return Batch(tokens=tok, targets=tok, frames=fr)


def map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of tensors (dicts, lists,
    NamedTuples, modules with a ``tree()`` view) and its spec tree (spec
    tuples are leaves there), in ``optim.tree_leaves``' order."""
    tree = as_tree(tree)
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, tree[k], specs[k])
                for k in sorted(tree)}
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_with_specs(fn, t, s)
                            for t, s in zip(tree, specs)))
    if isinstance(tree, list):
        return [map_with_specs(fn, t, s) for t, s in zip(tree, specs)]
    if tree is None:
        return None
    return fn(tree, specs)


def shard_tree(tree, specs, mesh):
    """This rank's block of each leaf of a tree of whole tensors."""
    return map_with_specs(lambda t, s: mesh.shard(t.detach(), s), tree,
                          specs)


def gather_tree(tree, specs, mesh):
    """Each leaf whole, all-gathered over its sharded axes."""
    return map_with_specs(lambda t, s: mesh.gather(t.detach(), s), tree,
                          specs)


def shard_params_(params: T.DecoderLM, specs, mesh) -> T.DecoderLM:
    """``params`` with each tensor replaced, in place, by this rank's
    block (the whole tensors are freed)."""
    with torch.no_grad():
        for name, module in params.named_children():
            if isinstance(module, nn.ModuleList):
                pairs = zip(module, specs[name])
            else:
                pairs = [(module, specs[name])]
            for block, spec in pairs:
                for k, p in block._parameters.items():
                    p.data = mesh.shard(p.data, spec[k])
    return params
