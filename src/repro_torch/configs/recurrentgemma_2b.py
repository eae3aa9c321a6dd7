"""RecurrentGemma-2B [arXiv:2402.19427] — Griffin: RG-LRU + local attn 1:2.

26L d_model=2560 10H (MQA kv=1) d_ff=7680 (GeGLU), vocab 256000,
lru_width=2560, local window 2048, head_dim 256; block pattern
(rglru, rglru, local-attn) cycled: 26 = 8*3 + 2.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "local"),
    rnn_width=2560, local_window=2048, act="gelu",
    tie_embeddings=True,
    # 10 heads on a 16-way model axis: pad to 16 (masked; §Perf).
    head_pad=16,
)
