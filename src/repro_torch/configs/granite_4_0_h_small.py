"""Granite-4.0-H-Small [hf:ibm-granite/granite-4.0-h-small] — GraniteMoeHybrid.

40L d_model=4096 vocab=100352 (tied), in four periods of 10: layers 5,
15, 25, 35 GQA attention (32 q / 8 kv heads of 128, NoPE), the other 36
Mamba-2 (128 heads of 64, state 128, conv 4 with bias, chunk 256, one
group).  Every layer's mixer is followed by an RMSNorm and the MoE: 72
experts of width 768, top 10, plus a SwiGLU shared MLP of width 1536
(n_shared_experts × d_expert).  Multipliers: embedding 12, attention
1/128, residual 0.22, logits / 16; RMSNorm eps 1e-5.  32.2 B
parameters.  Not in `ARCH_NAMES` (the reference has no such config).
"""
from repro_torch.models.config import ModelConfig

PERIOD = ("ssm",) * 5 + ("attn",) + ("ssm",) * 4

CONFIG = ModelConfig(
    name="granite-4.0-h-small", family="hybrid",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=768, vocab_size=100352,
    n_experts=72, n_shared_experts=2, experts_per_token=10, d_expert=768,
    ssm_state=128, ssm_heads=128, ssm_head_dim=64, ssm_expand=2,
    ssm_chunk=256, conv_width=4,
    block_pattern=PERIOD, use_rope=False, norm_eps=1e-5,
    embedding_multiplier=12.0, attention_multiplier=1 / 128,
    residual_multiplier=0.22, logits_scaling=16.0, tie_embeddings=True,
    # dropless: capacity = group size when capacity_factor = 72 / 10
    moe_group_size=256, capacity_factor=7.2,
)
