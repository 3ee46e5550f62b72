"""olmoe-1b-7b [moe] — 64 experts top-8 (fine-grained MoE).

16L d_model=2048 16H (GQA kv=16) d_ff=1024/expert vocab=50304
[arXiv:2409.02060]  64 experts shard 4-per-device over the 16-way model
axis (EP); dispatch lowers to the expert-parallel all-to-all.
Full attention => long_500k skipped.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv=16,
    d_ff=0, vocab=50304,
    n_experts=64, top_k=8, d_ff_expert=1024,
    expert_sharding="ep",
    mlp="swiglu", norm="rmsnorm",
    rope_theta=10_000.0, tie_embeddings=False,
    n_micro=4, prefill_chunk=8192,
)

SMOKE = CONFIG.with_(
    n_micro=1, loss_chunk=0,
    name="olmoe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=4,
    n_experts=8, top_k=2, d_ff_expert=64, vocab=256,
    remat=False,
)
