"""Parallel MSC builders — counterpart of `repro/core/parallel.py`.

Only the flat schedule on one device is ported, for one tensor
(`build_msc_parallel_flat`), for a bucket of B requests
(`build_msc_batched`) and as the continuous engine's chunk-resumable
programs (`MSCChunkPlan`): the three modes run one after another through
`ModeSchedule`.  On one device every relayout of the reference
("gspmd", "collective", "collective_stream") is the same local
transpose.  The grouped schedule and meshes of more than one device are
ROADMAP queue 1 item 9; the "auto" relayout and epilogue choosers are
queue 1 item 11.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .msc import MODE_PERMS, mode_slices
from .power_iter import SolveState
from .schedule import MULTI_DEVICE_TODO, ModeSchedule
from .types import MSCConfig, MSCResult, resolve_device

RELAYOUTS = ("gspmd", "collective", "collective_stream")

AUTO_TODO = ("the 'auto' choosers (relayout, epilogue, chunks per step) are "
             "not ported yet: ROADMAP.md, queue 1 item 11 (roofline)")

# column dim of modes 1/2 is m3, of mode 3 is m2 (see MODE_PERMS)
C_OF = (2, 2, 1)


def batch_perm(mode: int) -> tuple:
    """MODE_PERMS[mode] behind a leading request dim."""
    return (0,) + tuple(a + 1 for a in MODE_PERMS[mode])


def check_relayout(relayout: str, epilogue: str = "allgather") -> None:
    """Raise on a relayout (or epilogue) the one-device port cannot run."""
    if relayout == "auto" or epilogue == "auto":
        raise NotImplementedError(AUTO_TODO)
    if relayout not in RELAYOUTS:
        raise ValueError(f"unknown relayout {relayout!r}; "
                         f"expected one of {RELAYOUTS}")


def build_msc_parallel_flat(cfg: MSCConfig, device="cuda",
                            relayout: str = "gspmd"):
    """tensor → MSCResult on one device, flat schedule."""
    check_relayout(relayout)
    dev = resolve_device(device)
    sched = ModeSchedule(cfg)

    def run(tensor) -> MSCResult:
        t = torch.as_tensor(tensor).to(dev)
        modes = []
        for j in range(3):
            d, lam, iters, valid, m = sched.run_mode(mode_slices(t, j))
            modes.append(sched.finalize_mode(d, lam, iters, valid, m))
        return MSCResult(modes=tuple(modes))

    return run


def build_msc_batched(cfg: MSCConfig, device="cuda",
                      relayout: str = "gspmd"):
    """(batch (B, M1, M2, M3), dims (B, 3)) → MSCResult with a leading B.

    The request-batched flat schedule on one device: B independent MSC
    solves, bucket-padded to one shape with true sizes in `dims`, run
    through one set of batched contractions per mode.  Each request
    gates on its own (per-request `power_iters_run`); every field of the
    ModeResults carries the leading B dim at the padded size, and
    callers slice `[i, :dims[i, j]]` per request (MSCServeEngine does).
    """
    check_relayout(relayout, cfg.epilogue)
    dev = resolve_device(device)
    sched = ModeSchedule(cfg)

    def run(batch, dims) -> MSCResult:
        b = torch.as_tensor(batch).to(dev)
        dims = torch.as_tensor(dims, dtype=torch.int32).to(dev)
        modes = []
        for j in range(3):
            d, lam, iters, valid = sched.run_mode_batched(
                b.permute(batch_perm(j)).contiguous(), dims[:, j],
                dims[:, C_OF[j]])
            modes.append(sched.finalize_mode_batched(d, lam, iters, valid))
        return MSCResult(modes=tuple(modes))

    return run


class MSCChunkPlan:
    """The continuous engine's two programs per bucket, on one device.

    The static batched pipeline runs a bucket to completion: its gated
    loop ends on the batch's slowest request, so one slow request holds
    all B slots.  The chunk plan cuts that loop at the gate chunk:

      * `build_step()`: every slot's three modes advance
        `chunks_per_step` gate chunks over the persistent slot state, and
        the per-slot `finished` verdicts come back;
      * `build_refill()`: between chunks, the evicted slots are finalized
        (the similarity tail and the extraction, from their frozen
        iterates), then the table is repacked (an arbitrary slot
        permutation) and freed slots take newly admitted requests.

    State per mode: the slice-major block (B, m, r, c), read only between
    refills, and a `SolveState` carry (see `ModeSchedule`'s chunk-resumable
    entry points).  Holding all three unfoldings triples the tensor bytes
    resident against the static path's one layout at a time: the price of
    advancing the modes together.  Every computation keeps the leading
    slot dim, so results do not depend on slot placement, eviction order
    or arrival interleaving.

    The programs update the blocks and carries they are given in place,
    the port's counterpart of the reference's donated buffers; on a card
    the engine captures each as a CUDA graph (`serving/msc_engine.py`).
    Matrix-free only, as in the reference.
    """

    def __init__(self, cfg: MSCConfig, chunks_per_step=1, device="cuda"):
        if not cfg.matrix_free:
            raise ValueError("the continuous engine requires "
                             "matrix_free=True (see power_iter."
                             "build_chunk_fn)")
        if chunks_per_step == "auto":
            raise NotImplementedError(f"chunks_per_step='auto': {AUTO_TODO}")
        check_relayout("gspmd", cfg.epilogue)
        self.chunks_per_step = int(chunks_per_step)
        if self.chunks_per_step < 1:
            raise ValueError(f"chunks_per_step must be >= 1, got "
                             f"{chunks_per_step}")
        self.sched = ModeSchedule(cfg)
        self.device = resolve_device(device)

    # ---- shapes and state ---------------------------------------------
    @staticmethod
    def mode_shapes(bucket, B: int):
        """(B, m, r, c) block shape per mode (one device pads nothing)."""
        return tuple((B,) + tuple(bucket[i] for i in MODE_PERMS[j])
                     for j in range(3))

    def init_state(self, bucket, B: int, dtype):
        """A fresh slot table on the device: zero blocks, every slot inert
        (done, so frozen until the first refill).  Returns (blocks,
        carries), one of each per mode."""
        z = dict(device=self.device)
        blocks, carries = [], []
        for shape in self.mode_shapes(bucket, B):
            _, m, _, c = shape
            blocks.append(torch.zeros(shape, dtype=dtype, **z))
            carries.append(SolveState(
                v=torch.zeros((B, m, c), dtype=torch.float32, **z),
                lam=torch.zeros((B, m), dtype=torch.float32, **z),
                resid=torch.zeros((B, m), dtype=torch.float32, **z),
                iters=torch.zeros(B, dtype=torch.int32, **z),
                done=torch.ones(B, dtype=torch.bool, **z)))
        return tuple(blocks), tuple(carries)

    def export_slot(self, bucket, carries, slot: int):
        """Host form of one slot's three mode carries: per mode a
        SolveState of v (m, c), lam (m,), resid (m,), iters (int), done
        (bool), each mode's slice dim at its true bucket size."""
        out = []
        for j, carry in enumerate(carries):
            host = self.sched.export_carry(carry, bucket[MODE_PERMS[j][0]])
            out.append(SolveState(v=host.v[slot], lam=host.lam[slot],
                                  resid=host.resid[slot],
                                  iters=int(host.iters[slot]),
                                  done=bool(host.done[slot])))
        return out

    def export_carries(self, bucket, carries):
        """Host form of a bucket's three mode carries
        (`ModeSchedule.export_carry`)."""
        return [self.sched.export_carry(carry, bucket[MODE_PERMS[j][0]])
                for j, carry in enumerate(carries)]

    def import_carries(self, bucket, host_carries):
        """Device carries from `export_carries`' host form."""
        return tuple(self.sched.import_carry(host, bucket[MODE_PERMS[j][0]],
                                             self.device)
                     for j, host in enumerate(host_carries))

    def rebuild_blocks(self, bucket, B: int, dtype, arrs):
        """Device blocks from per-slot host tensors (None for a slot
        without a request, whose rows stay zero): each tensor's three
        unfoldings written into zero-padded blocks, as the engine stages
        an admitted request."""
        blocks = []
        for j, shape in enumerate(self.mode_shapes(bucket, B)):
            host = torch.zeros(shape, dtype=dtype)
            for s, arr in enumerate(arrs):
                if arr is None:
                    continue
                t = torch.as_tensor(np.asarray(arr)).permute(MODE_PERMS[j])
                host[s, :t.shape[0], :t.shape[1], :t.shape[2]] = t
            blocks.append(host.to(self.device))
        return tuple(blocks)

    # ---- the two programs ---------------------------------------------
    def build_step(self):
        """(blocks, carries) → (carries, finished (B,) bool).

        One scheduler tick: every slot's three modes advance
        `chunks_per_step` gate chunks (finished modes pass through
        frozen); the carries are updated in place.  A slot is finished
        once all three of its modes are converged or capped.  The blocks
        may be given in the precision policy's dtype (the engine's
        operand copies), so that nothing is cast per step.
        """
        sched = self.sched
        cap = sched.cfg.power_iters
        steps = self.chunks_per_step

        def step(blocks, carries):
            finished = None
            for block, carry in zip(blocks, carries):
                new = sched.chunk_local(block, carry, steps=steps)
                for f in dataclasses.fields(SolveState):
                    getattr(carry, f.name).copy_(getattr(new, f.name))
                fin = carry.done | (carry.iters >= cap)
                finished = fin if finished is None else finished & fin
            return carries, finished

        return step

    def build_refill(self):
        """(blocks, carries, dims, new_blocks, new_dims, take_new,
        new_done, perm) → (blocks, carries, results).

        First the finalize: `results` is the slot-padded batched MSCResult
        of every slot from the pre-repack state, under the pre-repack
        sizes `dims` (B, 3): the similarity tail and the extraction (on
        the device, no host read) from each slot's current iterates,
        frozen for a finished slot.  The engine reads the evicted slots'
        rows.  Then the repack, in place: slot s takes the fresh request
        of `new_blocks` (the staged unfoldings, `mode_shapes`) and
        `new_dims` where take_new[s], else old slot perm[s]'s state
        verbatim; new_done[s] seeds slot s inert.  The reference's warm
        and resume inputs are not ported yet (ROADMAP.md queue 1 item 10).
        """
        sched = self.sched
        dev = self.device

        def refill(blocks, carries, dims, new_blocks, new_dims, take_new,
                   new_done, perm):
            dims = torch.as_tensor(dims, device=dev)
            new_dims = torch.as_tensor(new_dims, device=dev)
            take_new = torch.as_tensor(take_new, device=dev).bool()
            new_done = torch.as_tensor(new_done, device=dev).bool()
            perm = torch.as_tensor(perm, device=dev).long()
            modes = []
            for j in range(3):
                block, carry = blocks[j], carries[j]
                B, m, _, c = block.shape
                valid = (torch.arange(m, device=dev)[None, :]
                         < dims[:, j][:, None])
                d, lam = sched.finalize_local(block, valid, carry.v)
                modes.append(sched.finalize_mode_batched(
                    d, lam, carry.iters[:, None], valid))
                fresh = sched.init_mode_carry(B, m, c, new_dims[:, C_OF[j]],
                                              new_done)
                sched.repack_local(perm, take_new, block, carry,
                                   new_blocks[j], fresh)
            return blocks, carries, MSCResult(modes=tuple(modes))

        return refill


def build_msc_parallel(cfg: MSCConfig, schedule: str = "flat", device="cuda",
                       **kw):
    if schedule == "flat":
        return build_msc_parallel_flat(cfg, device=device, **kw)
    if schedule == "grouped":
        raise NotImplementedError(
            f"schedule 'grouped': {MULTI_DEVICE_TODO}")
    raise ValueError(f"unknown schedule {schedule!r}")
