"""Gemma-2-27B [arXiv:2408.00118].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
Local(4096-window)/global alternating, attn softcap 50, final softcap 30,
head_dim=128.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
    d_ff=36864, vocab_size=256000, head_dim=128,
    attn_softcap=50.0, final_softcap=30.0,
    local_window=4096, global_every=2,
    rope_theta=1e4, tie_embeddings=True,
)
