"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (GQA kv=16) d_ff=1408/expert vocab=151936,
MoE: 60 routed experts top-4 + 4 shared (shared intermediate 4x1408).
QKV bias (qwen1.5 lineage).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936, qkv_bias=True,
    n_experts=60, n_shared_experts=4, experts_per_token=4, d_expert=1408,
    rope_theta=1e6,
    moe_group_size=256,      # see granite config / §Perf
    # 60 routed experts ∤ 16-way model axis: pad to 64 (router-masked,
    # never dispatched) so EP sharding divides (§Perf)
    expert_pad=64,
)
