"""InternVL2-26B [arXiv:2404.16821] — InternViT + InternLM2-20B backbone.

Backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
The InternViT frontend is a STUB: input_specs() provides precomputed
patch embeddings (B, n_patches, d_model) as a visual prefix.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92553, n_patches=256,
    rope_theta=1e6,
)
