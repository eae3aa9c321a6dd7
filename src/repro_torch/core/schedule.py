"""ModeSchedule on one device — counterpart of `repro/core/schedule.py`.

The reference's schedules run the per-device Alg. 2 body (eigensolve →
λ max → normalize → similarity epilogue) under `shard_map`.  This port
covers the one-device case: the slice dim needs no padding, the λ max
and the convergence gate need no collective, and both epilogues reduce
to one `_chunk_rowsum(V, V)` over the whole V, as the reference does
at one shard.  More than one device is ROADMAP queue 1 item 9.

Request batching: `run_mode_batched` / `finalize_mode_batched` run B
independent requests, bucket-padded to one (B, M, R, C) shape, through
the same body.  Every reduction stays per request (λ max, the gate, the
epilogue's block-diagonal |V Vᵀ| row-sum), padded slices are masked by
`valid`, and padded columns are kept at zero by masking the start
vectors to each request's true column count.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .extraction import extract_cluster
from .power_iter import compute_dtype, plan_eigensolve, top_eigenpairs
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
        """Cluster extraction + trimming on the device; the counts stay
        device tensors (no read back to the host)."""
        mask, n_it = extract_cluster(d, self.cfg.epsilon, valid,
                                     self.cfg.max_extraction_iters)
        return ModeResult(mask=mask[:m], d=d[:m], lambdas=lam[:m],
                          n_iters=n_it, power_iters_run=torch.amax(iters))

    def plan_mode_batched(self, slices: torch.Tensor, m_req: torch.Tensor,
                          c_req: torch.Tensor):
        """One mode's eigensolve for a bucket of B requests, planned (its
        operands made) but not run.

        slices (B, M, R, C): bucket-padded slice-major unfoldings, request
        i's data in the leading (m_req[i], r, c_req[i]) corner and zeros
        beyond.  m_req / c_req (B,) int: true slice and column counts
        (rows need no bound: zero rows add nothing to any contraction).
        Returns (Eigensolve, valid (B, M)).
        """
        m = slices.shape[1]
        valid = (torch.arange(m, device=slices.device)[None, :]
                 < m_req.to(slices.device)[:, None])
        plan = plan_eigensolve(slices, self.cfg,
                               c_valid=c_req.to(slices.device)[:, None])
        return plan, valid

    def run_mode_batched(self, slices: torch.Tensor, m_req: torch.Tensor,
                         c_req: torch.Tensor):
        """One mode for a bucket of B requests (see `plan_mode_batched`),
        run eagerly.  Returns (d, lam, iters (B, 1), valid (B, M)) at the
        padded size."""
        plan, valid = self.plan_mode_batched(slices, m_req, c_req)
        lam, vec, iters = plan.run()
        d, lam = self._similarity_tail(lam, vec, valid)
        return d, lam, iters[..., None], valid

    def finalize_mode_batched(self, d, lam, iters, valid) -> ModeResult:
        """Extraction of every request in one batched call (padding masked
        by `valid`).  Fields keep the leading B dim at the padded size;
        `n_iters` and `power_iters_run` are (B,) int device tensors, one
        count per request, never maxed across requests."""
        mask, n_it = extract_cluster(d, self.cfg.epsilon, valid,
                                     self.cfg.max_extraction_iters)
        return ModeResult(mask=mask, d=d, lambdas=lam, n_iters=n_it,
                          power_iters_run=torch.amax(iters, dim=-1))
