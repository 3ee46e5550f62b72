"""Model configuration of the LM zoo.

Port of ``repro.models.config``: one ``ModelConfig`` describes every
assigned architecture (dense GQA transformers, MoE, early-fusion VLM,
Mamba2 SSM, Zamba2 hybrid, Whisper enc-dec), with the reference's fields
and defaults.  The logical-to-mesh sharding rules (``DEFAULT_RULES``,
``logical_to_spec``, ``constrain``, ``tree_shardings``) belong to the
distributed slice; ``constrain`` is a no-op on one device, so the
single-device forward calls nothing in its place.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

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
