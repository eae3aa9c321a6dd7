"""Optimiser — counterpart of `repro.optim`."""
from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    global_norm)
from .schedule import cosine_warmup
from .compression import (
    CompressionState,
    compress_init,
    topk_compress_update,
)
