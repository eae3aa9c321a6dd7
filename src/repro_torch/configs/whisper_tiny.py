"""Whisper-tiny [arXiv:2212.04356] — encoder-decoder audio backbone.

4+4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.  The conv/mel frontend
is a STUB: input_specs() provides precomputed frame embeddings
(B, enc_context=1500, d_model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    n_enc_layers=4, enc_context=1500, act="gelu",
    tie_embeddings=True,
)
