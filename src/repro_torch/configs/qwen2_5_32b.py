"""Qwen2.5-32B [hf:Qwen/Qwen2.5-32B].

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064, QKV bias.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab_size=152064, qkv_bias=True,
    rope_theta=1e6,
    # 40 heads don't divide the 16-way model axis; pad to 48 (masked,
    # exact semantics — models/layers.py) so attention shards (§Perf).
    head_pad=48,
    # measured (§Perf it 3): ZeRO gathers + grad reduce-scatters scale
    # with the µbatch count; 4 is the fewest that still fits HBM
    # (12.6 GiB/device) and cuts the collective term 24% vs auto(16).
    microbatches=4,
)
