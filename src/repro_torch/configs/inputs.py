"""Concrete input batches — counterpart of `repro/configs/inputs.py:make_batch`.

Deterministic from an explicit `torch.Generator` (the reference seeds
jax.random; the two give different numbers from one seed, so parity
tests hand the reference's batch across through numpy instead).
Modality frontends are stubs, as in the reference: VLM batches get
precomputed patch embeddings, audio batches frame embeddings.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.config import ModelConfig


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
               kind: str = "train", device="cuda") -> Dict[str, Any]:
    """Deterministic batch on `device`: int32 tokens (and labels for
    `train`), plus 0.02·N(0, 1) patch or frame embeddings in the compute
    dtype."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, Any] = {
        "tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                generator=gen, device=device,
                                dtype=torch.int32),
    }
    if kind == "train":
        out["labels"] = torch.randint(0, cfg.vocab_size, (batch, seq),
                                      generator=gen, device=device,
                                      dtype=torch.int32)
    if cfg.family == "vlm" and cfg.n_patches:
        out["patches"] = (0.02 * torch.randn(
            (batch, cfg.n_patches, cfg.d_model), generator=gen,
            device=device)).to(cfg.cdtype)
    if cfg.is_encdec:
        out["frames"] = (0.02 * torch.randn(
            (batch, cfg.enc_context, cfg.d_model), generator=gen,
            device=device)).to(cfg.cdtype)
    return out
