"""qwen1.5-110b [dense] — the largest assigned dense arch; QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064 [hf:Qwen/Qwen1.5]
Full attention => long_500k skipped.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv=8,
    d_ff=49152, vocab=152064,
    qkv_bias=True, mlp="swiglu", norm="rmsnorm",
    rope_theta=1_000_000.0, tie_embeddings=False,
    loss_chunk=512, n_micro=16, prefill_chunk=8192, remat_group=8,
)

SMOKE = CONFIG.with_(
    n_micro=1, loss_chunk=0,
    name="qwen1.5-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv=2, d_ff=192, vocab=384,
    remat=False,
)
