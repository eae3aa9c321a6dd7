"""Mamba2-2.7B [arXiv:2405.21060] — attention-free SSD.

64L d_model=2560 vocab=50280 (rounded to 50288 pad-multiple as released),
d_state=128, expand=2 -> d_inner=5120, headdim=64 -> 80 ssm heads.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_heads=80, ssm_head_dim=64, ssm_expand=2,
    ssm_chunk=256, tie_embeddings=True,
)
