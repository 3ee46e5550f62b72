"""whisper-small [audio] — encoder-decoder; the conv/mel frontend is a
STUB per the assignment (input_specs provides precomputed frame
embeddings (B, 1500, d)).

12L d_model=768 12H d_ff=3072 vocab=51865 [arXiv:2212.04356]
Learned absolute positions (rope_theta=0), LayerNorm + GELU.
Full-attention decoder => long_500k skipped.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv=12,
    d_ff=3072, vocab=51865,
    enc_dec=True, n_enc_layers=12, enc_len=1500,
    mlp="gelu", norm="layernorm", rope_theta=0.0,
    tie_embeddings=True,
    n_micro=4,
)

SMOKE = CONFIG.with_(
    n_micro=1, loss_chunk=0,
    name="whisper-smoke",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv=4,
    d_ff=128, vocab=256, enc_len=32,
    remat=False,
)
