"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155,
MoE: 32 experts top-8, no shared experts.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64,
    n_experts=32, n_shared_experts=0, experts_per_token=8, d_expert=512,
    rope_theta=1e4, tie_embeddings=True,
    # dispatch cost/token ∝ group_size·k·cf — 256 measured 4× cheaper
    # than 1024 with identical routing semantics (§Perf granite cell)
    moe_group_size=256,
)
