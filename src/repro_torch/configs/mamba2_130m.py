"""mamba2-130m [ssm] — attention-free SSD (state-space duality).

24L d_model=768 d_ff=0 vocab=50280 ssm_state=128 [arXiv:2405.21060]
O(1) decode state => runs long_500k.  The paper's CA-matmul technique is
inapplicable here (no huge dense bottleneck) — see DESIGN.md
§Arch-applicability; the arch runs WITHOUT the technique.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
    ssm_ngroups=1, ssm_chunk=256,
    norm="rmsnorm", tie_embeddings=True,
    n_micro=2,
)

SMOKE = CONFIG.with_(
    n_micro=1, loss_chunk=0,
    name="mamba2-smoke",
    n_layers=2, d_model=64, vocab=256,
    ssm_state=16, ssm_headdim=16, ssm_chunk=16,
    remat=False,
)
