"""gemma2-27b [dense] — alternating local/global attention + logit softcaps.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000 [arXiv:2408.00118]
Alternating pattern is expressed as a scanned per-layer window array
(local layers window=4096, global layers 0); attn softcap 50, final 30.
Full-attention global layers => long_500k skipped.
The 256k-vocab lm_head is the paper-shaped huge matmul: the ca_lm_head
knob routes it through the 1.5D replicated matmul (see §Perf hillclimb).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv=16,
    d_ff=36864, vocab=256000, head_dim=128,
    local_global=True, local_window=4096,
    softcap=50.0, final_softcap=30.0,
    mlp="swiglu", norm="rmsnorm", post_norm=True,
    rope_theta=10_000.0, tie_embeddings=True,
    loss_chunk=512, n_micro=8,
)

SMOKE = CONFIG.with_(
    n_micro=1, loss_chunk=0,
    name="gemma2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=192, vocab=512,
    head_dim=16, local_window=32, remat=False,
)
