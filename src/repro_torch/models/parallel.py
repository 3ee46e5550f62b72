"""Tensor and expert parallelism over ``"model"`` in the sharded train step.

The reference gets this from XLA's SPMD partitioner: its parameters carry
the specs of ``config.logical_to_spec`` (heads, kv, mlp, vocab and experts
over ``"model"``, ``embed`` over ``"data"``), its activations carry
``constrain`` hints, and the partitioner places the collectives.  The port
writes out what that program computes on a mesh of ranks
(``launch.mesh.Mesh``):

  * the residual stream is replicated over the model team: each rank of a
    data shard holds the same rows;
  * attention (self and cross) splits by query heads (each rank its own,
    and the kv heads they read), the dense MLP by ``d_ff`` columns, the
    MoE by experts (``"ep"``, ``"ep_virtual"``) or by ``d_ff_expert``
    (``"tp"``), the Mamba2 block by SSM heads (each rank its own and the
    B / C groups they read), and the embedding, the head and the loss by
    vocabulary rows, in every group of layers (``blocks``, Whisper's
    ``enc``, Zamba2's ``shared``); a piece whose dimension the model team
    does not divide is computed whole on every rank, as the reference's
    rule drops that mapping;
  * each rank keeps its blocks of the parameters under their specs and
    gathers a layer's blocks over the FSDP axis (and, where the compute
    needs the whole leaf, over ``"model"``) when the layer runs: inside the
    layer's checkpoint, so remat gathers again instead of keeping them.

The collectives are ``torch.autograd.Function``\\ s over a team of a
:class:`~repro_torch.comm.group.Teams` (every one announced to the
collective watcher):

  ``copy_to``       identity forward, all-reduce backward: a replicated
                    input enters split compute;
  ``reduce_from``   all-reduce forward, identity backward: split compute's
                    partial sums leave it;
  ``gather_from``   all-gather along a dimension forward, reduce-scatter
                    backward: a block gathered for compute whose gradient
                    is partial on each rank (the FSDP gather; the summed
                    gradient lands as this rank's block);
  ``scatter_to``    reduce-scatter forward, all-gather backward (the
                    reverse pair);
  ``gather_whole``  all-gather forward, this rank's block of the gradient
                    backward: a block gathered for compute done whole and
                    alike on every rank (its gradient is already whole);
  ``block_of``      this rank's block forward, all-gather backward (the
                    reverse pair): a tensor whole and alike on every rank
                    enters split compute.

Inside split compute a rank's gradients are its share: summed over the
model team they make the whole.  So a leaf replicated over ``"model"``
that split compute reads (the kv projection where the kv heads do not
divide, the MoE router under "tp", chameleon's qk-norm, the SSM's
per-head vectors and gated-norm scale) gets ``copy_to`` on the weight,
and one that only whole compute reads (the norm scales, the MoE router
under "ep") gets none: its gradient is equal on every model rank.  Under
"ep" the MoE's dispatch, aux loss and combine run whole and alike on
every rank, as the reference's ``shard_map`` runs them, and only the
experts' MLP splits: ``block_of`` the dispatch buffer in, ``gather_whole``
the experts' outputs out, so each token's assignments are summed in one
process's order.  Under "tp" the aux loss is computed whole on every rank
and enters the loss as ``reduce_from(aux / m)``, its gradient a share
like the rest.

Serving on a mesh (``lm.make_prefill`` / ``make_decode_step`` with
``mesh=``) runs the same split, and ``split_model`` is then given the
cache's specs (``lm.cache_shardings``) too: each rank holds its blocks of
the cache, and :class:`Ring` / :class:`SsmState` say how the cached
attention and the Mamba2 block read and write them (an attention ring
split by kv heads over ``"model"`` and / or by slots over the axes of its
``kv_seq`` entry, the softmax then combined over that team; the SSM's
``conv`` and ``h`` gathered where their blocks do not follow the
compute's).
"""
from __future__ import annotations

import contextlib

import torch

from .config import ModelConfig, local_span, logical_to_spec, spec_axes

MODEL = "model"

# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def _cat(parts: torch.Tensor, dim: int) -> torch.Tensor:
    """The team's blocks, stacked on dim 0, joined along ``dim``."""
    return torch.cat(list(parts.unbind(0)), dim=dim)


def _reduce_scatter(team, x, axes, dim: int):
    return team.reduce_scatter(x.movedim(dim, 0).contiguous(),
                               axes).movedim(0, dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, team, axes):
        ctx.team, ctx.axes = team, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.team.psum(grad, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, team, axes):
        return team.psum(x, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, team, axes, dim):
        ctx.team, ctx.axes, ctx.dim = team, axes, dim
        return _cat(team.all_gather(x, axes), dim)

    @staticmethod
    def backward(ctx, grad):
        return (_reduce_scatter(ctx.team, grad, ctx.axes, ctx.dim), None,
                None, None)


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, team, axes, dim):
        ctx.team, ctx.axes, ctx.dim = team, axes, dim
        return _reduce_scatter(team, x, axes, dim)

    @staticmethod
    def backward(ctx, grad):
        return (_cat(ctx.team.all_gather(grad, ctx.axes), ctx.dim), None,
                None, None)


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, team, axes, dim):
        ctx.n, ctx.at, ctx.dim = (len(team.team(axes)), team.position(axes),
                                  dim)
        return _cat(team.all_gather(x, axes), dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.n, dim=ctx.dim)[ctx.at], None, None, None


class _BlockOf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, team, axes, dim):
        ctx.team, ctx.axes, ctx.dim = team, axes, dim
        n, at = len(team.team(axes)), team.position(axes)
        return x.chunk(n, dim=dim)[at].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return (_cat(ctx.team.all_gather(grad.contiguous(), ctx.axes),
                     ctx.dim), None, None, None)


def _one(team, axes) -> bool:
    return not axes or len(team.team(axes)) == 1


def copy_to(x, team, axes):
    """``x``, its gradient summed over the team ``axes``."""
    return x if _one(team, axes) else _CopyTo.apply(x, team, axes)


def reduce_from(x, team, axes):
    """The sum of ``x`` over the team ``axes``; its gradient passes as is."""
    return x if _one(team, axes) else _ReduceFrom.apply(x, team, axes)


def gather_from(x, team, axes, dim: int):
    """The team's blocks of ``x`` joined along ``dim`` (team order); the
    gradient summed over the team, this rank's block kept."""
    return x if _one(team, axes) else _GatherFrom.apply(x, team, axes, dim)


def scatter_to(x, team, axes, dim: int):
    """This rank's block along ``dim`` of the sum of ``x`` over the team;
    the gradient all-gathered."""
    return x if _one(team, axes) else _ScatterTo.apply(x, team, axes, dim)


def gather_whole(x, team, axes, dim: int):
    """The team's blocks of ``x`` joined along ``dim``; the gradient, whole
    and alike on every rank, cut back to this rank's block."""
    return x if _one(team, axes) else _GatherWhole.apply(x, team, axes, dim)


def block_of(x, team, axes, dim: int):
    """This rank's block along ``dim`` of ``x``, whole and alike on every
    rank of the team; the gradient all-gathered."""
    return x if _one(team, axes) else _BlockOf.apply(x, team, axes, dim)


# ---------------------------------------------------------------------------
# the layout of each leaf in compute
# ---------------------------------------------------------------------------

#: how a piece reads a leaf: ("split", dim) its own "model" block along
#: dim; "partial" whole, read by split compute; "whole" whole, read by
#: compute done alike on every model rank
SPLIT, PARTIAL, WHOLE = "split", "partial", "whole"


def _is_model(entry) -> bool:
    return spec_axes(entry) == (MODEL,)


class Split:
    """What the layers of one train step (or serve call) split over the
    model team of
    ``mesh``, decided from the parameters' ``specs`` (``lm.param_shardings``):
    ``heads`` (query heads; ``kv`` when the kv heads split too), ``mlp``,
    ``experts`` ("ep" over the dispatch experts, "tp" over
    ``d_ff_expert``, or None), ``ssm`` (the Mamba2 heads) and ``vocab``,
    each from whichever group holds the piece; ``m`` is the team's
    size."""

    def __init__(self, cfg: ModelConfig, mesh, specs: dict,
                 cache_specs: dict | None = None):
        self.mesh, self.specs = mesh, specs
        self.axes = (MODEL,) if MODEL in mesh.shape else ()
        self.m = mesh.axes_size(self.axes)
        rules = cfg.rules()

        def split(name: str, size: int) -> bool:
            # the reference's activation constraint splits this dimension
            # over exactly the model team
            return self.m > 1 and _is_model(
                logical_to_spec((name,), (size,), mesh, rules)[0])

        def span(name: str, size: int) -> tuple[int, int]:
            start, n = local_span(name, size, mesh, rules)
            return start, start + n

        def holder(name: str) -> dict:
            # the group whose blocks hold leaf ``name`` (Zamba2's attention
            # and MLP live in "shared", Whisper's encoder in "enc")
            for group in ("blocks", "shared", "enc"):
                spec = specs.get(group)
                spec = spec[0] if isinstance(spec, list) and spec else spec
                if spec and name in spec:
                    return spec
            return {}

        att, mlp, moe = holder("attn_wq"), holder("mlp_wu"), holder("moe_wg")
        self.heads = ("attn_wq" in att and _is_model(att["attn_wq"][1])
                      and split("q_heads", cfg.n_heads))
        self.kv = (self.heads and _is_model(att["attn_wk"][1])
                   and split("kv", cfg.n_kv))
        self.mlp = self.m > 1 and "mlp_wu" in mlp and _is_model(
            mlp["mlp_wu"][1])
        self.experts = None
        if self.m > 1 and "moe_wg" in moe:
            if _is_model(moe["moe_wg"][0]):
                self.experts = "ep"
            elif _is_model(moe["moe_wg"][2]):
                self.experts = "tp"
        ssm = holder("ssm_out")
        nh = cfg.ssm_nheads if "ssm_out" in ssm else 0
        # the SSM splits by heads, each rank reading the rank's "model"
        # block of the out-projection's rows (head-aligned when m | nh)
        self.ssm = (self.m > 1 and nh > 0 and nh % self.m == 0
                    and _is_model(ssm["ssm_out"][0]))
        self.vocab = self.m > 1 and _is_model(specs["embed"]["tok"][0])
        #: [start, stop) of this rank's query heads, SSM heads and
        #: vocabulary rows (the whole range where they do not split)
        self.q_span = span("q_heads", cfg.n_heads)
        self.ssm_span = span("heads", nh) if self.ssm else (0, nh)
        self.vocab_span = span("vocab", cfg.vocab_pad)
        #: [start, stop) of the B / C groups this rank's SSM heads read
        self.ssm_groups = (0, cfg.ssm_ngroups)
        if self.ssm:
            per = nh // cfg.ssm_ngroups
            h0, h1 = self.ssm_span
            self.ssm_groups = (h0 // per, (h1 - 1) // per + 1)
        self._plans = {group: self._plan(group) for group in specs}
        #: how this rank holds the serve cache (None outside serving)
        self.ring = self.ssm_state = None
        self.enc_out_spec = None
        if cache_specs is not None:
            ring = _find_spec(cache_specs, "k")
            if ring is not None:
                self.ring = Ring(self, ring[-4:])
            conv, h = _find_spec(cache_specs, "conv"), _find_spec(
                cache_specs, "h")
            if conv is not None:
                self.ssm_state = SsmState(self, conv[-3:], h[-4:])
            if "enc_out" in cache_specs:
                self.enc_out_spec = (None,) + tuple(
                    cache_specs["enc_out"][1:])

    # -- the pieces ----------------------------------------------------

    def kv_heads(self, cfg: ModelConfig) -> tuple[int, int]:
        """[k0, k1): the kv heads this rank's query heads read."""
        q0, q1 = self.q_span
        group = cfg.n_heads // cfg.n_kv
        return q0 // group, (q1 - 1) // group + 1

    def copy_to(self, x):
        return copy_to(x, self.mesh, self.axes)

    def reduce_from(self, x):
        return reduce_from(x, self.mesh, self.axes)

    def block_of(self, x, dim: int):
        return block_of(x, self.mesh, self.axes, dim)

    def gather_whole(self, x, dim: int):
        return gather_whole(x, self.mesh, self.axes, dim)

    def pmax(self, x):
        """The maximum over the model team (no gradient)."""
        return self.mesh.pmax(x, self.axes) if self.m > 1 else x

    def pmin(self, x):
        """The minimum over the model team (no gradient)."""
        return self.mesh.pmin(x, self.axes) if self.m > 1 else x

    def gather_heads(self, x, dim: int):
        """The model team's blocks of ``x`` joined along ``dim`` (no
        gradient): every query head from each rank's own."""
        return self.mesh.gather(x, (None,) * dim + (self.axes,)) \
            if self.m > 1 else x

    # -- the serve cache -----------------------------------------------

    def cached(self, name: str):
        """The plan of the cache leaves ``name`` ("ring", "ssm_state")
        reads; raises when ``split_model`` was given no cache specs."""
        plan = getattr(self, name)
        if plan is None:
            raise ValueError(f"a cached call inside split_model needs the "
                             f"cache's specs (lm.cache_shardings) for its "
                             f"{name}")
        return plan

    def enc_out_whole(self, t):
        """Whisper's stored encoder output, this rank's rows, whole over
        the axes its spec splits the sequence and width over."""
        return self.mesh.gather(t, self.cached("enc_out_spec"))

    def enc_out_block(self, t):
        """This rank's block of an encoder output whole but for its rows."""
        return self.mesh.shard(t, self.cached("enc_out_spec"))

    # -- the leaves ----------------------------------------------------

    def _mode(self, group: str, name: str):
        if group == "embed" and name in ("tok", "unembed"):
            return (SPLIT, 0) if self.vocab else WHOLE
        if group not in ("blocks", "enc", "shared"):
            return WHOLE
        kind, _, leaf = name.partition("_")
        if kind in ("attn", "xattn"):
            if not self.heads:
                return WHOLE
            if leaf in ("wq", "bq", "wo"):
                return (SPLIT, 1 if leaf == "wq" else 0)
            if leaf in ("wk", "wv", "bk", "bv"):
                return ((SPLIT, 1 if leaf[0] == "w" else 0) if self.kv
                        else PARTIAL)
            return PARTIAL                      # qnorm, knorm
        if kind == "mlp" and self.mlp and leaf != "bd":
            return (SPLIT, 1 if leaf in ("wg", "wu") else 0)
        if kind == "moe" and self.experts:
            if leaf == "router":
                return PARTIAL if self.experts == "tp" else WHOLE
            if self.experts == "ep":
                return (SPLIT, 0)
            return (SPLIT, 1 if leaf == "wd" else 2)
        if kind == "ssm" and self.ssm:
            # the in-projection's and the conv's "heads" dimension is the
            # concatenation z | x | B | C | dt, whose "model" blocks do not
            # line up with a rank's heads: read whole, the rank's columns
            # cut out (ssm.mamba2_block); the per-head vectors and the
            # gated norm's scale likewise
            return (SPLIT, 0) if leaf == "out" else PARTIAL
        return WHOLE

    def _plan(self, group: str) -> dict:
        spec = self.specs[group]
        spec = spec[0] if isinstance(spec, list) else spec
        plan = {}
        for name, s in spec.items():
            mode = self._mode(group, name)
            steps = []
            for dim, entry in enumerate(s):
                axes = self.mesh.key(spec_axes(entry))
                if not axes or self.mesh.axes_size(axes) == 1:
                    continue
                if MODEL in axes and axes != (MODEL,):
                    raise ValueError(f"{group}/{name}: spec entry {entry} "
                                     f"mixes {MODEL!r} with other axes")
                if mode == PARTIAL or MODEL not in axes:
                    steps.append((gather_from, axes, dim))
                elif mode == WHOLE:
                    steps.append((gather_whole, axes, dim))
                elif mode[1] != dim:
                    raise ValueError(f"{group}/{name}: split along dim "
                                     f"{mode[1]}, sharded over {MODEL!r} "
                                     f"along {dim} ({s})")
            # the FSDP axes first: their reduce-scatter in the backward
            # then runs on a block still split over "model"
            steps.sort(key=lambda step: MODEL in step[1])
            if mode == PARTIAL and self.m > 1 and not any(
                    MODEL in spec_axes(e) for e in s):
                steps.append((copy_to, self.axes, None))
            plan[name] = steps
        return plan

    def leaf(self, group: str, name: str, t):
        """Leaf ``name`` of a block of ``group`` as the compute reads it:
        gathered over the axes its spec shards and its piece needs
        whole."""
        for fn, axes, dim in self._plans[group][name]:
            t = (fn(t, self.mesh, axes) if dim is None
                 else fn(t, self.mesh, axes, dim))
        return t

    def view(self, group: str, p) -> dict:
        """Every leaf of ``p`` (one block of ``group``) as :meth:`leaf`."""
        return {name: self.leaf(group, name, p[name])
                for name in self._plans[group]}


def _find_spec(tree, leaf: str):
    """The spec of the first leaf named ``leaf`` in a cache spec tree
    (every attention ring of a model has one spec, as has every SSM
    state's leaf, whatever their leading ``"layers"`` entries)."""
    if leaf in tree and not isinstance(tree[leaf], dict):
        return tuple(tree[leaf])
    for sub in tree.values():
        if isinstance(sub, dict):
            found = _find_spec(sub, leaf)
            if found is not None:
                return found
    return None


class Ring:
    """How this rank holds one attention layer's ring ``{"k", "v": (B,
    Hkv, W, hd), "pos": (W,)}`` under the per-layer spec ``(batch, kv,
    kv_seq, none)`` of ``lm.cache_shardings``.  It holds the rank's own kv
    heads (those its query heads read) where the kv heads split over
    ``"model"`` (``Split.kv``), else every kv head, computed whole, for
    the slots it holds:

      * ``seq_axes``: the axes of the ``kv_seq`` entry (one or two of
        ``"data"`` and ``"model"``, those ``"batch"`` and ``"kv"`` left
        free), over which the W slots split into ``n_seq`` blocks, this
        rank's the ``seq_at``-th; ``()`` when the ring is whole;
      * ``q_all``: the slots split over the model team while the query
        heads split over it too, so each rank attends with every query
        head (gathered) against its slots, and the team's partial
        softmaxes combine.

    ``pos`` is replicated: every rank writes every slot's position.  A
    layout the split cannot honour (kv heads over ``"model"`` while the
    query heads do not split, or over another axis) raises."""

    def __init__(self, split: "Split", spec):
        mesh = split.mesh
        _, kv, seq, _ = spec
        kv_model = _is_model(kv) and split.m > 1
        if (spec_axes(kv) and not _is_model(kv)) or kv_model != split.kv:
            raise ValueError(
                f"the ring's kv heads are held under {kv!r} while the "
                f"attention splits them {'over' if split.kv else 'not over'}"
                f" {MODEL!r}: no split honours that")
        axes = mesh.key(spec_axes(seq))
        self.n_seq = mesh.axes_size(axes)
        self.seq_axes = axes if self.n_seq > 1 else ()
        self.seq_at = mesh.axes_index(axes) if self.seq_axes else 0
        self.q_all = split.heads and MODEL in self.seq_axes
        self.mesh = mesh

    def span(self, w_loc: int) -> tuple[int, int]:
        """[s0, s1): the ring slots of a block of ``w_loc`` slots."""
        return self.seq_at * w_loc, (self.seq_at + 1) * w_loc

    def pmax(self, x):
        return self.mesh.pmax(x, self.seq_axes)

    def psum(self, x):
        return self.mesh.psum(x, self.seq_axes)


class SsmState:
    """How this rank holds one Mamba2 layer's state: ``conv`` (B, K-1,
    conv_dim) under ``(batch, none, heads)`` and ``h`` (B, nh, hp, N)
    under ``(batch, heads, none, none)``.  ``conv``'s "model" blocks
    follow the channels x | B | C, not a rank's heads, so a call reads it
    whole (gathered over the model team) and keeps its block of the new
    rows; ``h`` splits by heads exactly when the block's heads split
    (``Split.ssm``), else it is read whole and its block kept."""

    def __init__(self, split: "Split", conv, h):
        self.mesh = split.mesh
        self.conv_spec = (None,) + tuple(conv[1:])
        self.h_spec = (None,) + tuple(h[1:])
        self.conv_axes = self.mesh.key(spec_axes(conv[2]))
        h_split = self.mesh.axes_size(spec_axes(h[1])) > 1
        if split.ssm and not (h_split and _is_model(h[1])):
            raise ValueError(f"the SSM heads split over {MODEL!r} but the "
                             f"state h is held under {h}")
        #: the compute's heads are the block's
        self.h_own = split.ssm

    def conv_span(self, conv_dim: int) -> tuple[int, int]:
        """[c0, c1): the conv channels of this rank's block."""
        n = self.mesh.axes_size(self.conv_axes)
        at = self.mesh.axes_index(self.conv_axes) if n > 1 else 0
        return at * (conv_dim // n), (at + 1) * (conv_dim // n)



_ACTIVE: Split | None = None


@contextlib.contextmanager
def split_model(cfg: ModelConfig, mesh, specs: dict,
                cache_specs: dict | None = None):
    """Inside the block the layers of ``cfg`` read their blocks under
    ``specs`` on ``mesh`` and split over its model team (see the module's
    docstring); outside it they compute whole, as in one process.
    ``cache_specs`` (``lm.cache_shardings``) are the serve cache's, when
    the block serves from a cache of this rank's blocks."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = Split(cfg, mesh, specs, cache_specs)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def active() -> Split | None:
    """The :class:`Split` of the enclosing :func:`split_model`, else None."""
    return _ACTIVE


def view(group: str, p):
    """``p`` as the compute reads it: :meth:`Split.view` inside
    :func:`split_model`, else ``p`` itself."""
    return p if _ACTIVE is None else _ACTIVE.view(group, p)


def leaf(group: str, p, name: str):
    """``p[name]`` as the compute reads it (:meth:`Split.leaf`)."""
    return p[name] if _ACTIVE is None else _ACTIVE.leaf(group, name,
                                                        p[name])
