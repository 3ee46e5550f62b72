"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768 [arXiv:2401.04088]
8 experts do not divide the 16-way model axis, so each expert is
split into 2 virtual f-slice experts (exact decomposition) giving 16
dispatch experts over the 16-way "model" axis — pure EP, no
within-expert all-reduce (see EXPERIMENTS.md §Perf).
SWA => runs long_500k.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv=8,
    d_ff=0, vocab=32768,
    n_experts=8, top_k=2, d_ff_expert=16384,
    expert_sharding="ep_virtual", virtual_split=2,
    window=8192, mlp="swiglu", norm="rmsnorm",
    rope_theta=1_000_000.0, tie_embeddings=False,
    n_micro=16, prefill_chunk=8192, remat_group=8,
)

SMOKE = CONFIG.with_(
    n_micro=1, loss_chunk=0,
    name="mixtral-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2,
    n_experts=4, top_k=2, d_ff_expert=96, vocab=256,
    window=32, remat=False,
)
