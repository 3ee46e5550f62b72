"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000 [arXiv:2401.16818; hf]
SWA => runs long_500k with a ring-buffered window cache.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv=8,
    d_ff=6912, vocab=32000,
    window=4096, mlp="swiglu", norm="rmsnorm",
    rope_theta=10_000.0, tie_embeddings=False,
    n_micro=2,
)

SMOKE = CONFIG.with_(
    n_micro=1, loss_chunk=0,
    name="h2o-danube-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
    window=32, remat=False,
)
