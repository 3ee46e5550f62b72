"""Model configuration of the LM zoo.

Port of ``repro.models.config``: one ``ModelConfig`` describes every
assigned architecture (dense GQA transformers, MoE, early-fusion VLM,
Mamba2 SSM, Zamba2 hybrid, Whisper enc-dec), with the reference's fields
and defaults, and the logical-to-mesh sharding rules: a tensor's
dimensions carry LOGICAL axis names, ``DEFAULT_RULES`` maps each to mesh
axes, and ``logical_to_spec`` resolves them on a mesh, falling back to
replication where a dimension does not divide its mapped axes.

A spec is a tuple with one entry per dimension: None (replicated), an
axis name, or a tuple of axis names (sharded over their product, the
first axis major), the entries of the reference's ``PartitionSpec``.
A mesh is anything with a ``.shape`` mapping axis name to size
(``launch.mesh.Mesh``, or a plain stand-in in the tests).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Sequence

# ---------------------------------------------------------------------------
# logical axes
# ---------------------------------------------------------------------------
# batch   — global batch            -> ("pod", "data") (DP)
# embed   — d_model                 -> "data"  (FSDP shards weights on embed)
# heads   — attention heads / d_ff  -> "model" (TP)
# kv      — kv heads                -> "model"
# vocab   — vocabulary              -> "model"
# expert  — MoE experts             -> "model" (EP) or None (TP-in-expert)
# seq     — sequence                -> None in train
# layers / conv / state / none      -> replicated

DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "embed": ("data",),
    "heads": ("model",),
    "kv": ("model",),
    "q_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "expert_mlp": (),       # d_ff inside an expert; EP archs keep it local
    "capacity": ("pod", "data"),  # MoE dispatch-buffer slot axis
    "seq": (),
    # decode KV-cache sequence axis: sequence-parallel fallback — takes the
    # first axis (pod > data > model) not already used by batch/kv-heads
    "kv_seq": ("pod", "data", "model"),
    "layers": (),
    "none": (),
}

VOCAB_PAD = 256  # embedding tables padded so "vocab" shards over any axis


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | vlm | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # default d_model // n_heads
    # attention flavor
    qkv_bias: bool = False
    window: int | None = None            # uniform sliding window
    local_global: bool = False           # gemma2 alternating local/global
    local_window: int = 4096
    softcap: float | None = None         # gemma2 logit softcapping
    final_softcap: float | None = None   # gemma2 final-logit softcap
    rope_theta: float = 10_000.0
    # MLP flavor
    mlp: str = "swiglu"                  # swiglu | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    expert_sharding: str = "ep"          # ep | tp | ep_virtual
    virtual_split: int = 2
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    # hybrid (zamba2): one shared attention block every `shared_every` layers
    shared_every: int = 0
    # enc-dec (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_len: int = 1500                  # stub frontend frame count
    # norms / misc
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    norm_eps: float = 1e-6
    post_norm: bool = False              # gemma2 post-attn/ffn norms
    tie_embeddings: bool = True
    # numerics / perf knobs
    dtype: str = "bfloat16"              # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    remat_group: int = 0
    attention_impl: str = "chunked"      # chunked (mea) | ref | flash
    attn_chunk: int = 1024               # kv-chunk of the mea attention
    scan_layers: bool = True
    n_micro: int = 1                     # microbatch accumulation steps
    prefill_chunk: int = 0               # chunked prefill segment (0 = off)
    # beyond-paper knobs
    ca_lm_head: bool = False
    loss_chunk: int = 0                  # chunked-sequence loss (0 = off)
    sharding_overrides: dict = field(default_factory=dict)

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def vocab_pad(self) -> int:
        """Embedding-table rows, padded to a multiple of ``VOCAB_PAD``
        (padded logit lanes are masked to -1e30 in ``lm_head``)."""
        return -(-self.vocab // VOCAB_PAD) * VOCAB_PAD

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def n_experts_disp(self) -> int:
        """Expert count seen by dispatch/buffers (virtual splits count)."""
        if self.expert_sharding == "ep_virtual":
            return self.n_experts * self.virtual_split
        return self.n_experts

    @property
    def d_ff_expert_disp(self) -> int:
        if self.expert_sharding == "ep_virtual":
            return self.d_ff_expert // self.virtual_split
        return self.d_ff_expert

    def rules(self) -> dict[str, tuple[str, ...]]:
        r = dict(DEFAULT_RULES)
        r.update(self.sharding_overrides)
        if self.n_experts and self.expert_sharding == "tp":
            r["expert"] = ()
            r["expert_mlp"] = ("model",)
        return r

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter count (for 6ND model flops) ---------------------------
    def param_count(self, *, active_only: bool = False) -> int:
        d, L = self.d_model, self.n_layers
        hd, Hq, Hkv = self.hd, self.n_heads, self.n_kv
        n = self.vocab * d                      # embeddings
        if not self.tie_embeddings:
            n += self.vocab * d
        if self.family == "ssm":
            return n + L * self._ssm_block_params()
        per_attn = d * (Hq * hd) + 2 * d * (Hkv * hd) + (Hq * hd) * d
        mlp_mult = 3 if self.mlp == "swiglu" else 2
        per_dense_mlp = mlp_mult * d * self.d_ff if self.d_ff else 0
        per_expert = mlp_mult * d * self.d_ff_expert
        if self.family == "hybrid":
            n += L * self._ssm_block_params()
            n += per_attn + per_dense_mlp       # ONE shared block
            return n
        if self.enc_dec:
            n += self.n_enc_layers * (per_attn + per_dense_mlp)
            n += L * (2 * per_attn + per_dense_mlp)   # self + cross attn
            return n
        if self.n_experts:
            e = self.top_k if active_only else self.n_experts
            n += L * (per_attn + e * per_expert + d * self.n_experts)
            return n
        n += L * (per_attn + per_dense_mlp)
        return n

    def _ssm_block_params(self) -> int:
        d, di, ns = self.d_model, self.d_inner, self.ssm_state
        g = self.ssm_ngroups
        nh = self.ssm_nheads
        in_proj = d * (2 * di + 2 * g * ns + nh)
        conv = self.ssm_conv * (di + 2 * g * ns)
        out_proj = di * d
        return in_proj + conv + out_proj + 2 * nh + di


# ---------------------------------------------------------------------------
# logical specs -> mesh specs
# ---------------------------------------------------------------------------

def _fits(size: int, axes: tuple[str, ...], mesh) -> bool:
    n = math.prod(mesh.shape[a] for a in axes)
    return n > 0 and size % n == 0


def logical_to_spec(logical: Sequence[str], shape: Sequence[int], mesh,
                    rules: dict[str, tuple[str, ...]]) -> tuple:
    """Map logical axis names to a spec, dropping any mapping the
    dimension size cannot honor and never using a mesh axis twice: the
    longest usable prefix of a name's mapped axes (those on the mesh and
    not yet used), else the first single axis that divides the size,
    else None (replicated)."""
    used: set[str] = set()
    out = []
    for name, size in zip(logical, shape):
        axes = tuple(a for a in rules.get(name, ())
                     if a in mesh.shape and a not in used)
        placed = False
        for k in range(len(axes), 0, -1):
            cand = axes[:k]
            if _fits(size, cand, mesh):
                out.append(cand if len(cand) > 1 else cand[0])
                used.update(cand)
                placed = True
                break
        if not placed:
            for a in axes:
                if size % mesh.shape[a] == 0:
                    out.append(a)
                    used.add(a)
                    placed = True
                    break
        if not placed:
            out.append(None)
    return tuple(out)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry: () for None, else its names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def constrain(x, logical: Sequence[str], rules: dict):
    """The reference's ``with_sharding_constraint`` hint, a no-op here.

    XLA's partitioner reads the hint and places collectives; the port
    places them itself.  A train step on a mesh (``lm.sharded_grads``),
    and prefill and decode on one (``lm.make_prefill`` /
    ``make_decode_step`` with ``mesh=``), run every family inside
    ``models.parallel.split_model``: each layer
    computes this rank's block of the dimensions the reference constrains
    over ``"model"`` (query heads, SSM heads, ``mlp``, experts, ``vocab``;
    :func:`local_span` gives the block), with ``parallel.copy_to`` /
    ``reduce_from`` where a replicated activation enters or leaves the
    split; the batch rows split over the batch team before the step.
    One process computes each layer whole, so an activation there has no
    layout to constrain."""
    return x


def local_span(name: str, size: int, mesh, rules: dict) -> tuple[int, int]:
    """(offset, extent) of this rank's block of a dimension of ``size``
    whose logical axis is ``name``: the block ``logical_to_spec`` gives
    it on ``mesh`` (with its ``coords``), the whole dimension where the
    rule's mapping is dropped."""
    (entry,) = logical_to_spec((name,), (size,), mesh, rules)
    at, n = 0, 1
    for a in spec_axes(entry):
        at, n = at * mesh.shape[a] + mesh.coords[a], n * mesh.shape[a]
    return at * (size // n), size // n


def tree_shardings(logical_tree, shape_tree, mesh,
                   rules: dict[str, tuple[str, ...]]):
    """A tree of specs from a tree of logical-axes tuples and a tree of
    the same structure whose leaves have a ``.shape`` (or are shapes)."""
    if isinstance(logical_tree, dict):
        return {k: tree_shardings(logical_tree[k], shape_tree[k], mesh,
                                  rules) for k in logical_tree}
    shape = getattr(shape_tree, "shape", shape_tree)
    return logical_to_spec(logical_tree, tuple(shape), mesh, rules)
