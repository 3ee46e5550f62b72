"""chameleon-34b [vlm] — early-fusion: VQ image tokens share the text
vocabulary, so the backbone is a plain decoder-only transformer with
qk-norm; the VQ-VAE image tokenizer is a STUB per the assignment
(input_specs provides token ids directly).

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 [arXiv:2405.09818]
Full attention => long_500k skipped.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv=8,
    d_ff=22016, vocab=65536,
    mlp="swiglu", norm="rmsnorm",
    rope_theta=10_000.0, tie_embeddings=False,
    loss_chunk=512, n_micro=16, prefill_chunk=8192, remat_group=4,
)

SMOKE = CONFIG.with_(
    n_micro=1, loss_chunk=0,
    name="chameleon-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv=2, d_ff=160, vocab=256,
    remat=False,
)
