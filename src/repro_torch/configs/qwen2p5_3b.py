"""qwen2.5-3b [dense] — GQA with QKV bias.

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936 [hf:Qwen/Qwen2.5; hf]
Full attention => long_500k skipped (see DESIGN.md §Arch-applicability).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv=2,
    d_ff=11008, vocab=151936,
    qkv_bias=True, mlp="swiglu", norm="rmsnorm",
    rope_theta=1_000_000.0, tie_embeddings=True,
    n_micro=2,
)

SMOKE = CONFIG.with_(
    n_micro=1, loss_chunk=0,
    name="qwen2.5-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=160, vocab=320,
    remat=False,
)
