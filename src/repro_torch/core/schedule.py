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

Chunk-resumable entry points (`init_mode_carry`, `chunk_local`,
`finalize_local`, `repack_local`, `export_carry`, `import_carry`) are
the continuous engine's per-mode body (`parallel.MSCChunkPlan`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .extraction import extract_cluster
from .power_iter import (SolveState, _init_vectors, build_chunk_fn,
                         compute_dtype, plan_eigensolve, rayleigh_fp32,
                         step_chunk, top_eigenpairs)
from .types import ModeResult, MSCConfig

EPILOGUES = ("allgather", "ring")

MULTI_DEVICE_TODO = ("multi-device schedules are not ported yet: "
                     "ROADMAP.md, queue 1 item 9")
TIERS_TODO = ("the serving tiers (autotuner, SLO scheduler, checkpoints, "
              "result cache, warm start, fault injection) are not ported "
              "yet: ROADMAP.md, queue 1 item 10")


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

    # ---- chunk-resumable entry points (the continuous engine) ----------
    #
    # The continuous engine keeps one SolveState per mode per slot table
    # on the device between dispatches (B slots, m the bucket's slice
    # count, c its column count):
    #
    #   v (B, m, c)  lam/resid (B, m)  iters/done (B,)
    #
    # The reference carries the per-request verdicts at (B, S), one
    # identical column per slice shard; one device has one shard, so
    # they are (B,) here, and no slice dim is padded (m_pad = m).

    def init_mode_carry(self, B: int, m_pad: int, c: int, c_req, done,
                        warm_v=None, use_warm=None, resume_lam=None,
                        resume_resid=None, resume_iters=None,
                        resume_done=None, use_resume=None) -> SolveState:
        """Fresh carry for one mode of a B-slot table.

        c_req: (B,) per-request column bounds masking the deterministic
        start vectors (the bucket-padding contract); done: (B,) bool,
        True seeds an inert slot (its iterate never advances).  Device
        ops only, on `done`'s device: the refill program runs this.  The
        reference's warm-start and resume inputs are not ported yet.
        """
        if any(x is not None for x in (warm_v, use_warm, resume_lam,
                                       resume_resid, resume_iters,
                                       resume_done, use_resume)):
            raise NotImplementedError(f"warm-start and resume inputs: "
                                      f"{TIERS_TODO}")
        done = torch.as_tensor(done, dtype=torch.bool)
        dev = done.device
        v = _init_vectors((B, m_pad), c, torch.float32,
                          c_valid=torch.as_tensor(c_req, device=dev)[:, None],
                          device=dev)
        z = dict(dtype=torch.float32, device=dev)
        return SolveState(v=v, lam=torch.zeros((B, m_pad), **z),
                          resid=torch.zeros((B, m_pad), **z),
                          iters=torch.zeros(B, dtype=torch.int32, device=dev),
                          done=done.clone())

    def chunk_local(self, block: torch.Tensor, carry: SolveState,
                    steps: int = 1) -> SolveState:
        """`steps` gate chunks of one mode over a carry: the resumable
        form of `mode_local`'s eigensolve.

        block (B, m, r, c) is read in the precision policy's dtype (a
        block already in that dtype is read as it is; another is cast
        here).  Every slot advances steps × power_check_every sweeps; a
        finished slot passes through frozen (`step_chunk`'s per-request
        masking), so the iterate it is finalized from does not depend on
        how many more chunks its table ran.  Padding slices are zero and
        hold the gate open nowhere, so no validity mask is needed.
        """
        cfg = self.cfg
        chunk_fn, k = build_chunk_fn(block, cfg)
        for _ in range(steps):
            carry = step_chunk(chunk_fn, carry, k=k, n_iters=cfg.power_iters,
                               tol=cfg.power_tol)
        return carry

    def finalize_local(self, block: torch.Tensor, valid_local: torch.Tensor,
                       v: torch.Tensor):
        """The similarity tail from a carry's (frozen) iterates: the fp32
        Rayleigh quotient on the block, the λ-max normalization and the
        epilogue.  Returns (d, λ).  The continuous engine runs it when a
        slot is evicted, not per chunk."""
        return self._similarity_tail(rayleigh_fp32(block, v), v, valid_local)

    @staticmethod
    def repack_local(perm, take_new, block: torch.Tensor, carry: SolveState,
                     new_block: torch.Tensor, new_carry: SolveState):
        """Slot-table compaction and refill for one mode, in place:
        block[s] ← new_block[s] where take_new[s], else the old
        block[perm[s]], and likewise every carry leaf.  Each old row is
        gathered into a scratch copy before any row is written, so any
        permutation is safe.  Returns (block, carry), the updated inputs
        (the port's counterpart of the reference's donated buffers)."""
        def sel(old, new):
            t = take_new.reshape((-1,) + (1,) * (old.dim() - 1))
            torch.where(t, new, old.index_select(0, perm), out=old)

        sel(block, new_block)
        for f in dataclasses.fields(SolveState):
            sel(getattr(carry, f.name), getattr(new_carry, f.name))
        return block, carry

    @staticmethod
    def export_carry(carry: SolveState, m: int) -> SolveState:
        """Host form (numpy) of one mode's carry, the slice dim trimmed to
        the true bucket size m: v (B, m, c), lam and resid (B, m), iters
        and done (B,).  Trimming is lossless: padded slices keep zero
        iterates after their first chunk."""
        def g(x):
            return x.detach().cpu().numpy()

        return SolveState(v=g(carry.v)[:, :m], lam=g(carry.lam)[:, :m],
                          resid=g(carry.resid)[:, :m], iters=g(carry.iters),
                          done=g(carry.done))

    @staticmethod
    def import_carry(host: SolveState, m_pad: int,
                     device="cpu") -> SolveState:
        """A device carry from `export_carry`'s host form, the slice dim
        padded with zeros to m_pad."""
        B, m = np.shape(host.lam)

        def padm(a, dtype):
            a = np.asarray(a, dtype)
            out = np.zeros((B, m_pad) + a.shape[2:], dtype)
            out[:, :m] = a
            return torch.from_numpy(out).to(device)

        return SolveState(
            v=padm(host.v, np.float32), lam=padm(host.lam, np.float32),
            resid=padm(host.resid, np.float32),
            iters=torch.from_numpy(np.asarray(host.iters, np.int32)).to(
                device),
            done=torch.from_numpy(np.asarray(host.done, bool)).to(device))
