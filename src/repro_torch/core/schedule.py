"""ModeSchedule on one device — counterpart of `repro/core/schedule.py`.

The reference's schedules run the per-device Alg. 2 body (eigensolve →
λ max → normalize → similarity epilogue) under `shard_map`.  This port
covers the one-device case: the slice dim needs no padding, the λ max
and the convergence gate need no collective, and both epilogues reduce
to one `_chunk_rowsum(V, V)` over the whole V, as the reference does
at one shard.  More than one device is ROADMAP queue 1 item 9.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .extraction import extract_cluster
from .power_iter import compute_dtype, top_eigenpairs
from .types import ModeResult, MSCConfig

EPILOGUES = ("allgather", "ring")

MULTI_DEVICE_TODO = ("multi-device schedules are not ported yet: "
                     "ROADMAP.md, queue 1 item 9")


def _chunk_rowsum(v_local: torch.Tensor, chunk: torch.Tensor,
                  acc: Optional[torch.Tensor], cfg: MSCConfig
                  ) -> torch.Tensor:
    """acc + Σ_j |v_local · chunkᵀ|_{:,j}: the abs_rowsum kernel when
    cfg.use_kernels, else a plain fp32 product of the operands."""
    if cfg.use_kernels:
        from repro_torch.kernels import ops as kops

        return kops.abs_rowsum(v_local, chunk, acc,
                               block_i=cfg.block_i or 128,
                               block_j=cfg.block_j or 128)
    prod = torch.abs(v_local.float() @ chunk.float().transpose(-1, -2))
    d = torch.sum(prod, dim=-1)
    return d if acc is None else acc + d


def epilogue_rowsum(v_local: torch.Tensor, *, cfg: MSCConfig,
                    shards: int = 1) -> torch.Tensor:
    """d = row sums of |V Vᵀ| from the rows of V, operands cast to the
    precision policy's dtype.  One shard only."""
    if cfg.epilogue not in EPILOGUES:
        raise ValueError(
            f"unknown epilogue {cfg.epilogue!r}; expected {EPILOGUES}")
    if shards != 1:
        raise NotImplementedError(MULTI_DEVICE_TODO)
    vl = v_local.to(compute_dtype(cfg.precision)).contiguous()
    # allgather: the gathered V is this device's V; ring: no neighbours
    return _chunk_rowsum(vl, vl, None, cfg)


@dataclasses.dataclass(frozen=True)
class ModeSchedule:
    """The flat schedule's per-mode body on one device."""

    cfg: MSCConfig

    def pad_slices(self, slices: torch.Tensor):
        """(m, r, c) → (slices, valid (m,), m); one shard pads nothing."""
        m = slices.shape[0]
        valid = torch.ones(m, dtype=torch.bool, device=slices.device)
        return slices, valid, m

    def mode_local(self, block: torch.Tensor, valid_local: torch.Tensor,
                   c_valid=None):
        """Eigensolve + similarity tail.  Returns (d, λ, iters (1,))."""
        lam, vec, iters = top_eigenpairs(block, self.cfg, c_valid=c_valid)
        d, lam = self._similarity_tail(lam, vec, valid_local)
        return d, lam, iters[..., None]

    def _similarity_tail(self, lam, vec, valid_local):
        """λ-max normalize + epilogue; padding slices zeroed in d and λ."""
        zero = torch.zeros((), dtype=torch.float32, device=lam.device)
        lam = torch.where(valid_local, lam, zero)
        lam_max = torch.amax(lam, dim=-1)  # the one-device λ MAX reduce
        scale = lam / torch.clamp(lam_max, min=1e-30)[..., None]
        v_local = torch.where(valid_local[..., None], scale[..., None] * vec,
                              zero)
        d = epilogue_rowsum(v_local, cfg=self.cfg)
        return torch.where(valid_local, d, zero), lam

    def run_mode(self, slices: torch.Tensor):
        padded, valid, m = self.pad_slices(slices)
        d, lam, iters = self.mode_local(padded, valid)
        return d, lam, iters, valid, m

    def finalize_mode(self, d, lam, iters, valid, m: int) -> ModeResult:
        """Cluster extraction + trimming on the device."""
        mask, n_it = extract_cluster(d, self.cfg.epsilon, valid,
                                     self.cfg.max_extraction_iters)
        return ModeResult(mask=mask[:m], d=d[:m], lambdas=lam[:m],
                          n_iters=n_it, power_iters_run=int(iters.max()))
