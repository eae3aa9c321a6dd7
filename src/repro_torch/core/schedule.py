"""ModeSchedule — counterpart of `repro/core/schedule.py`.

The reference's schedules run the per-device Alg. 2 body (eigensolve →
λ max → normalize → similarity epilogue) under `shard_map` over a mesh.
Here that body runs in every rank of a `torch.distributed` DeviceMesh
(`launch/mesh.py`), each rank on its own block; `mesh=None` is one
device, where no dim is padded and no collective runs.

Mesh roles (dims of the DeviceMesh, from `sharding/specs.py:msc_axes`):

  slice — shards the slice index m (the paper's group communicator); a
      slice role over several dims (a production (data, model) mesh) is
      one group over them, row-major:
      the λ max (all_reduce MAX), the lockstep convergence gate
      (all_reduce MAX before the chunk's host read) and the epilogue
      (all_gather, or the ring of p−1 send/receive steps) run over it.
  inner — shards the rows r within each slice: every contraction over r
      is a local partial and an all_reduce (SUM) over it; v, λ and d are
      the same on every inner rank.
  group — the grouped schedule's "mode" dim: one unfolding per group and
      no collective across groups until the results are gathered.

Padding: the slice dim pads to a multiple of the slice shards and r to a
multiple of the inner shards; zero rows add nothing to any contraction,
so only the slice mask (`valid`) is read.  Each rank's block is what the
reference's `block_spec` / `batched_block_spec` give its device.

Request batching: `run_mode_batched` / `finalize_mode_batched` run B
independent requests, bucket-padded to one (B, M, R, C) shape, through
the same body.  Every reduction stays per request (λ max, the gate, the
epilogue's block-diagonal |V Vᵀ| row-sum), padded slices are masked by
`valid`, and padded columns are kept at zero by masking the start
vectors to each request's true column count.

Chunk-resumable entry points (`init_mode_carry`, `chunk_local`,
`finalize_local`, `repack_local`, `export_carry`, `import_carry`) are
the continuous engine's per-mode body (`parallel.MSCChunkPlan`), on one
device or on each rank of a mesh.

Stages in isolation: `build_mode_runner` (one mode's eigensolve and epilogue
on a rank's block) and `build_epilogue_rowsum` (the epilogue alone on a
rank's rows of V), each a stage in isolation for the traced stage
reports (`launch/dryrun.py:lower_mode_stage`, `lower_epilogue`) and the
stage-level tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .extraction import extract_cluster
from .power_iter import (SolveState, _init_vectors, build_chunk_fn,
                         compute_dtype, merge_warm_start, plan_eigensolve,
                         rayleigh_fp32, step_chunk)
from .types import ModeResult, MSCConfig

EPILOGUES = ("allgather", "ring")


def pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def take_block(x: torch.Tensor, spans) -> torch.Tensor:
    """x[..., a0:a0+n0, a1:a1+n1, ...] over the trailing len(spans) dims,
    spans = ((a0, n0), (a1, n1), ...), zero-filled where a span runs past
    x's extent.  Contiguous; x may be a strided view (a permuted tensor),
    so a rank copies its block and nothing more."""
    k = len(spans)
    src = x[(Ellipsis,) + tuple(slice(a, a + n) for a, n in spans)]
    shape = tuple(x.shape[:x.dim() - k]) + tuple(n for _, n in spans)
    if tuple(src.shape) == shape:
        return src.contiguous()
    out = x.new_zeros(shape)
    out[(Ellipsis,) + tuple(slice(0, e) for e in src.shape[x.dim() - k:])] \
        = src
    return out


# ------------------------------------------------------------- collectives

def gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): x from each of the group's n ranks, in group-rank
    order (one all_gather_into_tensor)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    # all_gather_single where this torch has it (its new name), else the
    # same call under its old one
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x, group=group)
    return out.reshape((n,) + tuple(x.shape))


def _all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(..., b, c) → (..., n·b, c): the rows of every rank of the group in
    rank order.  all_gather_into_tensor gathers along dim 0, so under a
    leading request dim the row dim moves to the front and back."""
    g = gather_stack(x.movedim(-2, 0), group)  # (n, b, ..., c)
    g = g.reshape((-1,) + tuple(g.shape[2:]))  # (n·b, ..., c)
    return g.movedim(0, -2).contiguous()


def _ring_peers(group):
    """(the group's size, the global ranks of the next and of the previous
    rank around it)."""
    import torch.distributed as dist

    p, i = dist.get_world_size(group), dist.get_rank(group)
    return (p, dist.get_global_rank(group, (i + 1) % p),
            dist.get_global_rank(group, (i - 1) % p))


def _exchange(send: torch.Tensor, to: int, recv: torch.Tensor, frm: int,
              group):
    """Post one send and one receive (global peer ranks); returns the
    works to wait on."""
    import torch.distributed as dist

    return dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, to, group),
        dist.P2POp(dist.irecv, recv, frm, group)])


# ------------------------------------------------------------------ epilogue

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


def _ring_rowsum(v_local: torch.Tensor, cfg: MSCConfig, group
                 ) -> torch.Tensor:
    """Ring similarity epilogue: p−1 steps, each sending the chunk of V
    this rank holds to rank i+1 of the group and receiving rank i−1's.

    Rank i folds its own chunk first, then the chunks of i−1, i−2, … as
    they arrive: the summation order of `kernels/ref.py:ring_rowsum(
    chunks, start=i)`.  Step k+1's send and receive are posted before
    step k's row sum, so the transfer overlaps the kernel; the full V is
    never held (one chunk in flight and one landing).
    """
    p, nxt, prv = _ring_peers(group)
    pending = None
    if p > 1:
        buf = torch.empty_like(v_local)
        pending = (buf, _exchange(v_local, nxt, buf, prv, group))
    d = _chunk_rowsum(v_local, v_local, None, cfg)
    for k in range(1, p):
        chunk, works = pending
        for w in works:
            w.wait()
        if k < p - 1:
            buf = torch.empty_like(chunk)
            pending = (buf, _exchange(chunk, nxt, buf, prv, group))
        d = _chunk_rowsum(v_local, chunk, d, cfg)
    return d


def epilogue_rowsum(v_local: torch.Tensor, *, cfg: MSCConfig,
                    group=None) -> torch.Tensor:
    """d_local = row-block sums of |V Vᵀ| from this rank's rows of V.

    v_local: (rows, c), or (B, rows, c) for B batched requests (every
    product stays per request).  The paper's MPI_Allgatherv(M) and full
    |V Vᵀ| row sum, under cfg.epilogue: "allgather" gathers V over the
    slice group (O(m·c) held), "ring" streams its chunks (O(m·c/p)).
    Operands are cast to the precision policy's dtype before the
    collective, so bf16_fp32 also halves the bytes sent.  Without a group
    (one device) both are one row sum over the whole V.
    """
    if cfg.epilogue not in EPILOGUES:
        raise ValueError(
            f"unknown epilogue {cfg.epilogue!r}; expected {EPILOGUES}")
    vl = v_local.to(compute_dtype(cfg.precision)).contiguous()
    if group is None:
        return _chunk_rowsum(vl, vl, None, cfg)
    if cfg.epilogue == "ring":
        return _ring_rowsum(vl, cfg, group)
    return _chunk_rowsum(vl, _all_gather_rows(vl, group), None, cfg)


def gather_shards(d: torch.Tensor, lam: torch.Tensor, iters: torch.Tensor,
                  group):
    """The slice-sharded d and λ (..., b) and the sweep counts (..., 1) of
    every rank of the group, joined: d and λ (..., n·b) in rank order,
    iters (..., n).  One all_gather of fp32 (the counts are exact in
    fp32); a device collective, no host read."""
    b = d.shape[-1]
    packed = torch.cat([d, lam, iters.to(d.dtype)], dim=-1)
    g = gather_stack(packed, group)  # (n, ..., 2b + 1)

    def rows(x):
        return x.movedim(0, -2).reshape(tuple(x.shape[1:-1]) + (-1,))

    return (rows(g[..., :b]), rows(g[..., b:2 * b]),
            g[..., 2 * b].movedim(0, -1).to(torch.int32))


@dataclasses.dataclass(frozen=True)
class ModeSchedule:
    """One mode-layout declaration: which mesh dims shard what (see the
    module docstring).  ModeSchedule(cfg) is one device."""

    cfg: MSCConfig
    mesh: object = None
    slice_axes: tuple = ()
    inner_axes: tuple = ()
    group_axes: tuple = ()

    def __post_init__(self):
        if self.mesh is None:
            if self.slice_axes or self.inner_axes or self.group_axes:
                raise ValueError("mesh roles need a mesh")
            return
        names = tuple(self.mesh.mesh_dim_names or ())
        roles = self.group_axes + self.slice_axes + self.inner_axes
        missing = [a for a in roles if a not in names]
        if missing:
            raise ValueError(f"dims {missing} not in mesh {names}")
        if len(set(roles)) != len(roles):
            raise ValueError(f"overlapping dim roles: {roles}")
        if not self.slice_axes:
            raise ValueError("ModeSchedule needs a slice dim")
        if len(self.inner_axes) > 1:
            raise ValueError(f"one inner dim at most, got {self.inner_axes}")

    # ---- static mesh facts -------------------------------------------
    def _role(self, axes):
        """(group, size, index) of a role (`launch/mesh.py:axes_group`);
        a slice role over several dims is one group, row-major."""
        if not axes:
            return None, 1, 0
        from repro_torch.launch.mesh import axes_group

        return axes_group(self.mesh, axes)

    def _size(self, axes) -> int:
        return self._role(axes)[1]

    def _group(self, axes):
        return self._role(axes)[0]

    def _index(self, axes) -> int:
        return self._role(axes)[2]

    @property
    def slice_shards(self) -> int:
        return self._size(self.slice_axes)

    @property
    def inner_shards(self) -> int:
        return self._size(self.inner_axes)

    @property
    def slice_group(self):
        """The slice dim's process group (None on one device)."""
        return self._group(self.slice_axes)

    @property
    def inner_group(self):
        """The inner dim's process group (None without an inner dim)."""
        return self._group(self.inner_axes)

    @property
    def slice_index(self) -> int:
        return self._index(self.slice_axes)

    @property
    def inner_index(self) -> int:
        return self._index(self.inner_axes)

    # ---- padding / masking -------------------------------------------
    def pad_amounts(self, m: int, r: int):
        """(m_pad, r_pad): slice dim to even slice shards, row dim to even
        inner shards (zero rows drop out of every contraction)."""
        return pad_to(m, self.slice_shards), pad_to(r, self.inner_shards)

    def slice_mask(self, m_pad: int, m, device) -> torch.Tensor:
        """The mask of this rank's m_pad/p slices: True below m, an int,
        or below each request's m, a (B,) tensor, under a request dim."""
        b = m_pad // self.slice_shards
        idx = torch.arange(self.slice_index * b, (self.slice_index + 1) * b,
                           device=device)
        if isinstance(m, int):
            return idx < m
        return idx[None, :] < m.to(device)[:, None]

    def local_block(self, slices: torch.Tensor, m_req=None):
        """This rank's block of a slice-major unfolding (..., m, r, c),
        which may be a strided view: (..., m'/p, r'/q, c), contiguous and
        zero-padded, and its slice mask (`slice_mask`, below m_req (B,)
        under a leading request dim)."""
        m, r = slices.shape[-3:-1]
        m_pad, r_pad = self.pad_amounts(m, r)
        b, rq = m_pad // self.slice_shards, r_pad // self.inner_shards
        block = take_block(slices, ((self.slice_index * b, b),
                                    (self.inner_index * rq, rq),
                                    (0, slices.shape[-1])))
        return block, self.slice_mask(m_pad, m if m_req is None else m_req,
                                      slices.device)

    # ---- the per-rank body (paper Alg. 2, minus extraction) ----------
    def mode_local(self, block: torch.Tensor, valid_local: torch.Tensor,
                   c_valid=None):
        """Eigensolve + similarity tail on this rank's block (b, r_local,
        c) or (B, b, r_local, c).  Returns (d_local, λ_local, iters (1,) or
        (B, 1)), the sweeps equal on every slice rank (lockstep gate)."""
        lam, vec, iters = plan_eigensolve(
            block, self.cfg, c_valid=c_valid, slice_group=self.slice_group,
            inner_group=self.inner_group).run()
        d, lam = self._similarity_tail(lam, vec, valid_local)
        return d, lam, iters[..., None]

    def _similarity_tail(self, lam, vec, valid_local):
        """λ-max normalize + epilogue; padding slices zeroed in d and λ."""
        zero = torch.zeros((), dtype=torch.float32, device=lam.device)
        lam = torch.where(valid_local, lam, zero)
        lam_max = torch.amax(lam, dim=-1)
        group = self.slice_group
        if group is not None:
            import torch.distributed as dist

            # MPI_Allreduce(λ, MAX) over the group, fp32 whatever the
            # precision
            dist.all_reduce(lam_max, op=dist.ReduceOp.MAX, group=group)
        scale = lam / torch.clamp(lam_max, min=1e-30)[..., None]
        v_local = torch.where(valid_local[..., None], scale[..., None] * vec,
                              zero)
        d = epilogue_rowsum(v_local, cfg=self.cfg, group=group)
        return torch.where(valid_local, d, zero), lam

    def run_mode(self, slices: torch.Tensor):
        """One mode of the flat schedule from its slice-major unfolding
        (m, r, c) (a view is enough: each rank copies its block).
        Returns (d_local, λ_local, iters, valid (m',), m)."""
        block, valid_local = self.local_block(slices)
        d, lam, iters = self.mode_local(block, valid_local)
        m = slices.shape[-3]
        m_pad, _ = self.pad_amounts(m, slices.shape[-2])
        return d, lam, iters, torch.arange(m_pad, device=d.device) < m, m

    def gather(self, d, lam, iters):
        """d, λ and the sweep counts of the whole slice dim on every rank
        (`gather_shards`); unchanged on one device."""
        if self.slice_group is None:
            return d, lam, iters
        return gather_shards(d, lam, iters, self.slice_group)

    def extract_mode(self, d, lam, iters, valid, m: int) -> ModeResult:
        """Cluster extraction + trimming of a whole mode on the device (the
        counts stay device tensors: no read back to the host)."""
        mask, n_it = extract_cluster(d, self.cfg.epsilon, valid,
                                     self.cfg.max_extraction_iters)
        return ModeResult(mask=mask[:m], d=d[:m], lambdas=lam[:m],
                          n_iters=n_it, power_iters_run=torch.amax(iters))

    def finalize_mode(self, d, lam, iters, valid, m: int) -> ModeResult:
        """d and λ gathered to every rank, then the extraction on each
        (the paper's Gatherv to a root, run everywhere instead): every
        rank holds the same result."""
        return self.extract_mode(*self.gather(d, lam, iters), valid, m)

    def plan_mode_batched(self, slices: torch.Tensor, m_req: torch.Tensor,
                          c_req: torch.Tensor):
        """One mode's eigensolve for a bucket of B requests, planned (its
        operands made) but not run.

        slices (B, M, R, C): bucket-padded slice-major unfoldings (a view
        is enough), request i's data in the leading (m_req[i], r, c_req[i])
        corner and zeros beyond.  m_req / c_req (B,) int: true slice and
        column counts (rows need no bound: zero rows add nothing to any
        contraction).  Returns (Eigensolve, valid_local (B, M'/p)).
        """
        block, valid = self.local_block(slices, m_req)
        return self.plan_block_batched(block, c_req), valid

    def plan_block_batched(self, block: torch.Tensor, c_req: torch.Tensor):
        """The Eigensolve of this rank's block (B, b, r_local, c) of a
        bucket, start vectors masked to the requests' column counts c_req
        (B,)."""
        return plan_eigensolve(block, self.cfg,
                               c_valid=c_req.to(block.device)[:, None],
                               slice_group=self.slice_group,
                               inner_group=self.inner_group)

    def run_mode_batched(self, slices: torch.Tensor, m_req: torch.Tensor,
                         c_req: torch.Tensor):
        """One mode for a bucket of B requests (see `plan_mode_batched`),
        run eagerly.  Returns (d_local, λ_local, iters (B, 1), valid (B,
        M')), valid at the padded size."""
        plan, valid_local = self.plan_mode_batched(slices, m_req, c_req)
        lam, vec, iters = plan.run()
        d, lam = self._similarity_tail(lam, vec, valid_local)
        m_pad, _ = self.pad_amounts(*slices.shape[-3:-1])
        valid = (torch.arange(m_pad, device=d.device)[None, :]
                 < m_req.to(d.device)[:, None])
        return d, lam, iters[..., None], valid

    def finalize_mode_batched(self, d, lam, iters, valid) -> ModeResult:
        """Extraction of every request in one batched call (padding masked
        by `valid`), after the slice gather.  Fields keep the leading B dim
        at the padded size; `n_iters` and `power_iters_run` are (B,) int
        device tensors, one count per request, never maxed across
        requests."""
        d, lam, iters = self.gather(d, lam, iters)
        mask, n_it = extract_cluster(d, self.cfg.epsilon, valid,
                                     self.cfg.max_extraction_iters)
        return ModeResult(mask=mask, d=d, lambdas=lam, n_iters=n_it,
                          power_iters_run=torch.amax(iters, dim=-1))

    # ---- chunk-resumable entry points (the continuous engine) ----------
    #
    # The continuous engine keeps one SolveState per mode per slot table
    # on the device between dispatches; each rank holds its block (B
    # slots, m' the bucket's slice count padded to the slice shards, S
    # the slice shards, c the column count):
    #
    #   v (B, m'/S, c)  lam/resid (B, m'/S)  iters/done (B,)
    #
    # The reference carries the per-request verdicts at (B, S), one
    # identical column per slice shard (the gate all-reduces over the
    # slice dims); here each rank holds its column, (B,), the same on
    # every rank.  On one device S = 1 and nothing is padded.

    def local_rows(self, m_pad: int) -> int:
        """This rank's share of a padded slice dim."""
        return m_pad // self.slice_shards

    def init_mode_carry(self, B: int, m_pad: int, c: int, c_req, done,
                        warm_v=None, use_warm=None, resume_lam=None,
                        resume_resid=None, resume_iters=None,
                        resume_done=None, use_resume=None) -> SolveState:
        """Fresh carry for one mode of a B-slot table: this rank's rows of
        the padded slice dim m_pad.

        c_req: (B,) per-request column bounds masking the deterministic
        start vectors (the bucket-padding contract; every slice starts
        from the same vector, so a rank makes its rows alone); done: (B,)
        bool, True seeds an inert slot (its iterate never advances).
        Device ops only, on `done`'s device: the refill program runs
        this.

        warm_v (B, m_pad, c) and use_warm (B,): the warm-start admission.
        Slot b starts from warm_v[b] (a cached near-duplicate's iterates,
        re-normalized by `merge_warm_start`) where use_warm[b], else from
        the deterministic start.

        resume_lam / resume_resid (B, m_pad), resume_iters (B,),
        resume_done (B,) and use_resume (B,): the preempt-to-host
        re-admission.  Where use_resume[b], slot b takes its whole
        exported state back: warm_v[b] verbatim (not re-normalized, so a
        resumed solve keeps the bits of one never preempted), λ, the
        residuals, the sweep count and the verdict.  Each rank takes its
        own rows of the staged (B, m_pad, …) inputs.  use_warm and
        use_resume never both hold for a slot (the engine's contract).
        """
        done = torch.as_tensor(done, dtype=torch.bool)
        dev = done.device
        b = self.local_rows(m_pad)
        lo = self.slice_index * b
        v = _init_vectors((B, b), c, torch.float32,
                          c_valid=torch.as_tensor(c_req, device=dev)[:, None],
                          device=dev)
        wv = None
        if warm_v is not None:
            wv = warm_v[:, lo:lo + b].to(torch.float32)
            if use_warm is not None:
                v = merge_warm_start(
                    v, wv, torch.as_tensor(use_warm, device=dev).bool())
        z = dict(dtype=torch.float32, device=dev)
        lam = torch.zeros((B, b), **z)
        resid = torch.zeros((B, b), **z)
        iters = torch.zeros(B, dtype=torch.int32, device=dev)
        if use_resume is not None:
            ur = torch.as_tensor(use_resume, device=dev).bool()
            v = torch.where(ur[:, None, None], wv, v)
            lam = torch.where(ur[:, None], resume_lam[:, lo:lo + b], lam)
            resid = torch.where(ur[:, None], resume_resid[:, lo:lo + b],
                                resid)
            iters = torch.where(ur, resume_iters.to(torch.int32), iters)
            done = torch.where(ur, resume_done.bool(), done)
        return SolveState(v=v, lam=lam, resid=resid, iters=iters,
                          done=done.clone())

    def chunk_local(self, block: torch.Tensor, carry: SolveState,
                    steps: int = 1, route=None) -> SolveState:
        """`steps` gate chunks of one mode over this rank's carry: the
        resumable form of `mode_local`'s eigensolve.

        block (B, m'/S, r'/Q, c) is read in the precision policy's dtype (a
        block already in that dtype is read as it is; another is cast
        here).  Every slot advances steps × power_check_every sweeps; a
        finished slot passes through frozen (`step_chunk`'s per-request
        masking), so the iterate it is finalized from does not depend on
        how many more chunks its table ran.  On a mesh every sweep's
        partials are summed over the inner group and the gate reduces over
        the slice group, so every rank's verdicts agree.  Padding slices
        are zero and hold the gate open nowhere, so no validity mask is
        needed.  `route` forces the power kernel's route (with kernels on a
        card; see `kernels/power_iter.py`).
        """
        cfg = self.cfg
        chunk_fn, k = build_chunk_fn(block, cfg, inner_group=self.inner_group,
                                     route=route)
        for _ in range(steps):
            carry = step_chunk(chunk_fn, carry, k=k, n_iters=cfg.power_iters,
                               tol=cfg.power_tol,
                               slice_group=self.slice_group)
        return carry

    def finalize_local(self, block: torch.Tensor, valid_local: torch.Tensor,
                       v: torch.Tensor):
        """The similarity tail from a carry's (frozen) iterates: the fp32
        Rayleigh quotient on the block (summed over the inner group), the
        λ-max normalization and the epilogue over the slice group.
        Returns this rank's (d, λ).  The continuous engine runs it when a
        slot is evicted, not per chunk."""
        return self._similarity_tail(
            rayleigh_fp32(block, v, self.inner_group), v, valid_local)

    @staticmethod
    def repack_local(perm, take_new, block: torch.Tensor, carry: SolveState,
                     new_block: torch.Tensor, new_carry: SolveState):
        """Slot-table compaction and refill for one mode, in place:
        block[s] ← new_block[s] where take_new[s], else the old
        block[perm[s]], and likewise every carry leaf.  Each old row is
        gathered into a scratch copy before any row is written, so any
        permutation is safe.  The slot dim is whole on every rank, so a
        repack moves no bytes between ranks.  Returns (block, carry), the
        updated inputs (the port's counterpart of the reference's donated
        buffers)."""
        def sel(old, new):
            t = take_new.reshape((-1,) + (1,) * (old.dim() - 1))
            torch.where(t, new, old.index_select(0, perm), out=old)

        sel(block, new_block)
        for f in dataclasses.fields(SolveState):
            sel(getattr(carry, f.name), getattr(new_carry, f.name))
        return block, carry

    def export_carry(self, carry: SolveState, m: int) -> SolveState:
        """Host form (numpy) of one mode's carry, the slice dim gathered
        from every slice rank and trimmed to the true bucket size m: v (B,
        m, c), lam and resid (B, m), iters and done (B,).  Trimming is
        lossless: padded slices keep zero iterates after their first
        chunk.  On a mesh every rank calls it (a collective)."""
        v, lam, resid = carry.v, carry.lam, carry.resid
        group = self.slice_group
        if group is not None:
            v = _all_gather_rows(v, group)
            rows = _all_gather_rows(torch.stack([lam, resid], dim=-1),
                                    group)
            lam, resid = rows[..., 0], rows[..., 1]

        def g(x):  # a copy: on the CPU .numpy() would alias the carry
            return x.detach().cpu().numpy().copy()

        return SolveState(v=g(v)[:, :m], lam=g(lam)[:, :m],
                          resid=g(resid)[:, :m], iters=g(carry.iters),
                          done=g(carry.done))

    def import_carry(self, host: SolveState, m_pad: int,
                     device="cpu") -> SolveState:
        """This rank's device carry from `export_carry`'s host form (from
        any mesh): the slice dim padded with zeros to m_pad and this rank's
        rows taken."""
        B, m = np.shape(host.lam)
        b = self.local_rows(m_pad)
        lo = self.slice_index * b

        def padm(a, dtype):
            a = np.asarray(a, dtype)
            out = np.zeros((B, m_pad) + a.shape[2:], dtype)
            out[:, :m] = a
            return torch.from_numpy(np.ascontiguousarray(
                out[:, lo:lo + b])).to(device)

        return SolveState(
            v=padm(host.v, np.float32), lam=padm(host.lam, np.float32),
            resid=padm(host.resid, np.float32),
            iters=torch.from_numpy(np.asarray(host.iters, np.int32)).to(
                device),
            done=torch.from_numpy(np.asarray(host.done, bool)).to(device))


# ------------------------------------------------------ stages in isolation

def build_mode_runner(sched: ModeSchedule, c_valid: Optional[int] = None):
    """(block_local, valid_local) → (d_local, λ_local, iters): one mode's
    eigensolve + similarity epilogue stage in isolation, its inputs
    already distributed to the schedule's ranks.

    The reference commits its inputs to the schedule's shardings, so that
    the compiled stage receives the block already cut, as at production
    scale; here a rank is handed only its own block, never the whole
    tensor: `ModeSchedule.local_block`'s (m'/p, r'/q, c) and its slice
    mask (m'/p,).  Every rank calls it (the stage's collectives run over
    the schedule's groups).  `launch/dryrun.py:lower_mode_stage` traces it
    for the per-rank eigensolve working set; the tests use it for
    stage-level parity."""
    def run(block: torch.Tensor, valid_local: torch.Tensor):
        return sched.mode_local(block, valid_local, c_valid=c_valid)

    return run


@dataclasses.dataclass(frozen=True)
class EpilogueStage:
    """The similarity epilogue alone over the rows of V that one group's
    ranks hold (`build_epilogue_rowsum`).  Called on this rank's rows
    (m_pad/p, c) it returns this rank's rows of d: `epilogue_rowsum` and
    nothing else, so a trace of one call holds only the epilogue's own
    collectives.  `rows` and `gather` cut V and join d around it."""

    cfg: MSCConfig
    group: object
    shards: int
    index: int

    def __call__(self, v_rows: torch.Tensor) -> torch.Tensor:
        return epilogue_rowsum(v_rows, cfg=self.cfg, group=self.group)

    def rows(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole V (m, c), padded with zero rows to
        even shards (the reference's `pad_to`)."""
        b = pad_to(v.shape[0], self.shards) // self.shards
        return take_block(v, ((self.index * b, b), (0, v.shape[1])))

    def gather(self, d_rows: torch.Tensor, m: int) -> torch.Tensor:
        """d (m,) whole on every rank from each rank's rows: one
        all_gather over the group (`gather_stack`), the padding dropped.
        Every rank calls it; it is not part of the stage."""
        if self.group is None:
            return d_rows[:m]
        return gather_stack(d_rows, self.group).reshape(-1)[:m]


def build_epilogue_rowsum(mesh, cfg: MSCConfig,
                          axis_name=None) -> EpilogueStage:
    """The similarity epilogue in isolation: an `EpilogueStage` over the
    group of the mesh dims `axis_name` (a dim name or a tuple of them; by
    default every dim of the mesh, one group over them row-major,
    `launch/mesh.py:axes_group`), under cfg.epilogue.

    `launch/dryrun.py:lower_epilogue` traces it to set the all-gather's
    traffic and landing buffer beside the ring's (the reference's
    benchmarks/ring_epilogue.py); the tests use it for epilogue-only
    parity."""
    from repro_torch.launch.mesh import axes_group

    if axis_name is None:
        axes = tuple(mesh.mesh_dim_names)
    else:
        axes = (axis_name,) if isinstance(axis_name, str) else tuple(
            axis_name)
    group, shards, index = axes_group(mesh, axes)
    return EpilogueStage(cfg, group, shards, index)
