"""Input stand-ins and concrete batches — counterpart of
`repro/configs/inputs.py`.

`input_specs(cfg, shape)` gives the abstract inputs each step is traced
with (`launch/dryrun.py`: no allocation): tensors on the `meta` device,
the reference's ShapeDtypeStructs with the same keys, shapes and dtypes.
`make_batch` gives a concrete batch.  Concrete batches are deterministic from an explicit `torch.Generator` (the reference seeds
jax.random; the two give different numbers from one seed, so parity
tests hand the reference's batch across through numpy instead).
Modality frontends are stubs, as in the reference: VLM batches get
precomputed patch embeddings, audio batches frame embeddings.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.config import ModelConfig, ShapeConfig


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _extras_specs(cfg: ModelConfig, batch: int) -> Dict[str, Any]:
    out = {}
    if cfg.family == "vlm" and cfg.n_patches:
        out["patches"] = _spec((batch, cfg.n_patches, cfg.d_model),
                               cfg.cdtype)
    if cfg.is_encdec:
        out["frames"] = _spec((batch, cfg.enc_context, cfg.d_model),
                              cfg.cdtype)
    return out


def train_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    return {
        "tokens": _spec((b, s), torch.int32),
        "labels": _spec((b, s), torch.int32),
        **_extras_specs(cfg, b),
    }


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    return {
        "tokens": _spec((b, s), torch.int32),
        **_extras_specs(cfg, b),
    }


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Decode traces the serve step: ONE new token against a seq_len KV
    cache."""
    b = shape.global_batch
    return {
        "tokens": _spec((b, 1), torch.int32),
        "cache_len": _spec((), torch.int32),
    }


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    if shape.kind == "train":
        return train_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_specs(cfg, shape)
    return decode_specs(cfg, shape)


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
