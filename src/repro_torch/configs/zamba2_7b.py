"""zamba2-7b [hybrid] — Mamba2 backbone + ONE shared attention block
(single parameter set) invoked every `shared_every` Mamba2 layers, each
invocation with its own KV cache.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 ssm_state=64 vocab=32000
[arXiv:2411.15242]  81 = 27 groups x 3 mamba layers.
Sub-quadratic backbone => runs long_500k (shared-attn caches shard their
kv_seq axis over the data axis when batch=1).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32,
    d_ff=14336, vocab=32000,
    shared_every=3,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
    ssm_ngroups=1, ssm_chunk=256,
    mlp="swiglu", norm="rmsnorm",
    rope_theta=10_000.0, tie_embeddings=True,
    n_micro=4,
)

SMOKE = CONFIG.with_(
    n_micro=1, loss_chunk=0,
    name="zamba2-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256,
    shared_every=2,
    ssm_state=16, ssm_headdim=16, ssm_chunk=16,
    remat=False,
)
