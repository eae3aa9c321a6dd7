"""Batched multi-tensor MSC serving, on one device or on a mesh of ranks.

Counterpart of the engines in `repro/serving/msc_engine.py`.  Many
independent MSC requests share one dispatch per microbatch:

  * shape buckets — request dims round up to multiples of
    `bucket_quantum`, so nearby shapes share one padded shape.  Padding
    rides ModeSchedule's validity masks: per-request slice counts mask
    the padded slices and per-request column counts mask the start
    vectors, so a padded request solves the same problem as the
    unpadded one.
  * one captured program per bucket — where the reference compiles one
    executable per (bucket, microbatch size, dtype, mesh, config), the
    engine captures CUDA graphs per bucket (its B, dtype and config are
    the engine's): for each mode a head (the unfolding into a static
    buffer, the operands and start vectors; on `--gram` the
    `batched_gram` formation), the gate chunk, and the tail (λ,
    the λ-max normalization, the epilogue and the extraction).  A
    dispatch replays them, with one host read per gate chunk, the
    reference's; the request sizes are device tensors written in place,
    so every request of a warm bucket replays without a capture.
    `compiles` counts the graphs captured and `exec_cache_hits` the
    dispatches that only replayed.  On the CPU, which the caller asks
    for explicitly, the same steps run eagerly, and `compiles` counts the
    first dispatch of each bucket, where the reference compiles.
  * microbatch assembly — requests of a bucket are packed into the
    bucket's static batch of exactly `max_batch` slots, short ones filled
    with (1, 1, 1) zero requests that converge at the first gate probe
    and never hold the batch back.

On a mesh (`launch/mesh.py:make_msc_mesh`, the flat schedule's roles)
every rank builds the engine with the same arguments, submits the same
requests in the same order and packs its own block of each; every rank
then captures and replays the same graphs in the same order, each holding
the bucket's collectives (the gate's all_reduce, the λ max, the epilogue,
the gather of d and λ), and every decision the host makes (the gated
loop's exit, admission, eviction, rotation) reads values that are the
same on every rank.  Results and `ServeStats` come back the same on every
rank.  Bucket dims round up to the shard counts too (`_bucket_quantum`).

A warm engine holds each bucket's static buffers and graph pool
(`memory_reckoning`: one rank's bytes); `close()` releases them.  Results come back per
request on the host (CPU tensors and Python ints), trimmed to the true
sizes, with each request's own `power_iters_run`.  The eager runner
`core.parallel.build_msc_batched` computes the same results and is what
the graphs are held against.

`MSCContinuousEngine` replaces the static microbatch with a
continuous-batching decode loop: per-bucket slot tables of persistent
device state advance in gate chunks, finished requests are evicted (and
finalized) between chunks, and freed slots refill from an admission
queue, so a slow request no longer holds B − 1 slots to the batch's last
chunk.  Each bucket runs two programs (`core.parallel.MSCChunkPlan`),
captured on a card as two CUDA graphs: the chunk step and the refill.
Its serving tiers are the reference's: a content-addressed result cache
with warm starts (`serving/result_cache.py`), the SLO scheduler
(priority classes, deadlines, aging, preempt-to-host, shedding) and
fault tolerance (periodic checkpoints through `checkpoint/store.py`,
restore onto any device or mesh, injected faults with bounded retries
and the sequential fallback, `serving/faults.py`).  Warm, resumed and
restored admissions all go through the same refill program.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
import time
import warnings
from collections import defaultdict, deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.checkpoint.store import (gc_checkpoints, load_leaves,
                                          restorable_steps, save_checkpoint)
from repro_torch.core.autotune import AutotuneCache
from repro_torch.core.fingerprint import (cache_salt, host_array,
                                          result_cache_key, spectral_sketch)
from repro_torch.core.msc import MODE_PERMS, msc_sequential
from repro_torch.core.parallel import (C_OF, MSCChunkPlan, _collective_blocks,
                                       _flat_schedule, _mesh_device,
                                       _resolve_auto, agreed, batch_perm,
                                       check_relayout, collective_pads)
from repro_torch.core.power_iter import (SolveState, _gated_loop,
                                         compute_dtype, init_solve_state,
                                         predict_remaining_sweeps)
from repro_torch.core.schedule import ModeSchedule, pad_to
from repro_torch.core.types import ModeResult, MSCConfig, MSCResult
from repro_torch.roofline import expected_queue_wait
from repro_torch.serving.faults import LoadShedError
from repro_torch.serving.graphs import Step, warm_up

# filler requests need >= 1 valid slice and column per mode: an all-zero
# (1, 1, 1) request has zero residual (its gate fires at the first probe)
# and a nonempty masked start vector (no 0/0)
_FILLER_DIMS = (1, 1, 1)


@dataclasses.dataclass(frozen=True)
class ServeStats:
    """Counters of the serving hot path (cumulative per engine), with the
    reference's fields.

    Both engines fill `requests`, `dispatches`, `compiles` (CUDA graphs
    captured; on the CPU, the first dispatch of each program of a
    bucket, where the reference compiles) and `exec_cache_hits`
    (dispatches, or continuous ticks, that only replayed).  The static
    engine fills `filler_slots`.  The continuous engine fills
    `chunk_steps` and `refills` (the dispatches of its two programs),
    `evictions` (requests served), `slot_chunks` / `busy_slot_chunks`
    (slot·chunk capacity dispatched and the share holding a live
    request: their ratio is the occupancy), `queue_wait_chunks` (ticks
    requests spent queued), the rolling p50 / p99 of those waits and
    `idle_bucket_ticks` (ticks that left a slot free while the bucket's
    queue held work), and the serving tiers' counters: fault tolerance
    (`checkpoints_written`, `restores`, `retries`, `shed_requests`,
    `fallback_requests`), the result cache (`cache_hits`,
    `cache_misses`, `warm_starts`, `warm_sweeps_saved`) and the SLO
    scheduler (`preemptions`, `resumes`, `deadline_misses`,
    `slo_sheds`) and the autotuner (`autotune_searches`: resolutions
    that ran a live search, `autotune_cache_hits`: resolutions served
    from the autotune cache); see `repro/serving/msc_engine.py:ServeStats`.
    The multi-host counters (`heartbeats_missed`, `host_losses`,
    `reinits`, `shard_files_written`) are bumped by the control plane
    (`launch/distributed.py`, through `note_ft_event`)."""

    requests: int = 0
    dispatches: int = 0
    compiles: int = 0
    exec_cache_hits: int = 0
    filler_slots: int = 0
    chunk_steps: int = 0
    refills: int = 0
    evictions: int = 0
    slot_chunks: int = 0
    busy_slot_chunks: int = 0
    queue_wait_chunks: int = 0
    checkpoints_written: int = 0
    restores: int = 0
    retries: int = 0
    shed_requests: int = 0
    fallback_requests: int = 0
    heartbeats_missed: int = 0
    host_losses: int = 0
    reinits: int = 0
    shard_files_written: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    warm_starts: int = 0
    warm_sweeps_saved: int = 0
    autotune_searches: int = 0
    autotune_cache_hits: int = 0
    preemptions: int = 0
    resumes: int = 0
    deadline_misses: int = 0
    slo_sheds: int = 0
    idle_bucket_ticks: int = 0
    queue_wait_p50_chunks: float = 0.0
    queue_wait_p99_chunks: float = 0.0

    @property
    def occupancy(self) -> float:
        """Live-slot share of dispatched slot·chunk capacity."""
        return (self.busy_slot_chunks / self.slot_chunks
                if self.slot_chunks else 0.0)

    def delta(self, other: "ServeStats") -> "ServeStats":
        return ServeStats(*(a - b for a, b in
                            zip(dataclasses.astuple(self),
                                dataclasses.astuple(other))))


def _bucket_quantum(bucket_quantum: int, sched=None) -> int:
    """The quantum rounded up to a multiple of the schedule's shard counts
    (`sched`: the engine's ModeSchedule), so that bucket padding already
    meets the schedule's even-shard contract.  Each dim is a slice dim (a
    multiple of p) in one mode and a row dim (a multiple of q) in another,
    so lcm(p, q) is enough, not p·q.  One device has one shard: the
    quantum stands."""
    if int(bucket_quantum) < 1:
        raise ValueError(f"bucket_quantum must be >= 1, got {bucket_quantum}")
    if sched is None:
        return int(bucket_quantum)
    return pad_to(int(bucket_quantum),
                  math.lcm(sched.slice_shards, sched.inner_shards))


def _bucket_of(shape: Sequence[int], quantum: int) -> Tuple[int, int, int]:
    if len(shape) != 3 or any(s < 1 for s in shape):
        raise ValueError(f"MSC serves third-order tensors, got {shape}")
    return tuple(-(-int(s) // quantum) * quantum for s in shape)


class _BucketProgram:
    """The programs of one bucket: static buffers and, per mode, the
    head, gate-chunk and tail `Step`s, captured on the first `run()` in
    one graph memory pool.

    `batch` (B, M1, M2, M3) and `dims` (B, 3) are written in place per
    dispatch; on one device `flat` holds modes 1 and 2's unfoldings in
    turn (mode 0's is the batch itself).  On a mesh each head cuts this
    rank's block of its mode's unfolding from the batch ("gspmd"), or the
    first head makes all three by the all_to_all relayout ("collective",
    "collective_stream": `core/parallel.py:_collective_blocks`) and each
    head takes its own.  Everything else the steps use (blocks, operands,
    the solve carry, results) is allocated by the captures from the pool,
    at addresses every replay reuses.  The tail drops the mode's operands
    once captured, so the next mode's head may reuse their memory: the
    steps replay in the order they were captured.
    """

    def __init__(self, sched: ModeSchedule, bucket, batch: int, dtype,
                 device: torch.device, relayout: str = "gspmd"):
        self.sched = sched
        self.device = device
        self.relayout = relayout
        self.batch = torch.zeros((batch,) + tuple(bucket), dtype=dtype,
                                 device=device)
        self.dims = torch.ones((batch, 3), dtype=torch.int32, device=device)
        self.flat = torch.empty(0 if sched.mesh is not None
                                else self.batch.numel(), dtype=dtype,
                                device=device)
        self.coll: List[Optional[torch.Tensor]] = [None] * 3
        self.pool = (torch.cuda.graph_pool_handle()
                     if device.type == "cuda" else None)
        self.steps: List[Optional[Tuple[Step, Step, Step]]] = [None] * 3
        self.live: List[dict] = [{} for _ in range(3)]
        self.compiles = 0

    @property
    def static_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.batch, self.dims, self.flat))

    @property
    def pool_bytes(self) -> int:
        return sum(st.pool_bytes for steps in self.steps if steps
                   for st in steps)

    @property
    def graphs(self) -> int:
        return sum(st.captured for steps in self.steps if steps
                   for st in steps)

    def release(self) -> None:
        """Drop the steps, their graphs and what the captures allocated
        (the relayout's blocks among it): the pool's memory goes back
        now, not when the engine is dropped."""
        self.steps = [None] * 3
        self.live = [{} for _ in range(3)]
        self.coll = [None] * 3

    def load(self, tensors) -> np.ndarray:
        """Write the requests into the static batch (the rest zero) and
        their sizes into `dims`; returns the sizes (B, 3) on the host,
        filler slots (1, 1, 1)."""
        b = self.batch.shape[0]
        self.batch.zero_()
        dims = np.tile(np.int32(_FILLER_DIMS), (b, 1))
        for s, t in enumerate(tensors):
            if not isinstance(t, torch.Tensor):
                t = torch.from_numpy(np.array(t))
            m1, m2, m3 = t.shape
            self.batch[s, :m1, :m2, :m3] = t.to(self.device, self.batch.dtype)
            dims[s] = t.shape
        self.dims.copy_(torch.from_numpy(dims))
        return dims

    def _head(self, j: int) -> None:
        sched = self.sched
        m_req, c_req = self.dims[:, j], self.dims[:, C_OF[j]]
        if sched.mesh is not None and self.relayout != "gspmd":
            if j == 0:
                self.coll = list(_collective_blocks(
                    sched, self.batch, self.relayout == "collective_stream"))
            m_pad = collective_pads(sched, self.batch.shape[1:])[j]
            # the slot stays filled: the warm-up and the capture each call
            # this head, and the replays read the blocks head 0's capture
            # made, at their addresses, until `release`
            plan = sched.plan_block_batched(self.coll[j], c_req)
            valid = sched.slice_mask(m_pad, m_req, self.device)
        else:
            if j == 0 or sched.mesh is not None:
                slices = self.batch.permute(batch_perm(j))
            else:
                src = self.batch.permute(batch_perm(j))
                slices = self.flat[:src.numel()].view(src.shape)
                slices.copy_(src)
            m_pad, _ = sched.pad_amounts(*slices.shape[-3:-1])
            plan, valid = sched.plan_mode_batched(slices, m_req, c_req)
        whole = (torch.arange(m_pad, device=self.device)[None, :]
                 < m_req[:, None])
        self.live[j].update(plan=plan, valid=valid, whole=whole,
                            gated=plan.gated, n_iters=plan.n_iters,
                            state=init_solve_state(plan.v0))

    def _chunk(self, j: int) -> None:
        live = self.live[j]
        state = live["state"]
        new = live["plan"].step(state)
        for f in dataclasses.fields(SolveState):
            getattr(state, f.name).copy_(getattr(new, f.name))

    def _tail(self, j: int) -> ModeResult:
        live = self.live[j]
        state = live["state"]
        d, lam = self.sched._similarity_tail(live.pop("plan").finish(state),
                                             state.v, live.pop("valid"))
        return self.sched.finalize_mode_batched(d, lam, state.iters[..., None],
                                                live.pop("whole"))

    def _steps(self, j: int) -> Tuple[Step, Step, Step]:
        if self.steps[j] is None:
            fns = (self._head, self._chunk, self._tail)
            warm_up([functools.partial(f, j) for f in fns], self.device)
            self.steps[j] = tuple(Step(f, self.device, self.pool, (j,))
                                  for f in fns)
            if self.device.type == "cuda":
                self.compiles += sum(st.captured for st in self.steps[j])
            elif j == 0:  # nothing to capture: count the bucket's first
                self.compiles += 1  # dispatch, where the reference compiles
        return self.steps[j]

    def run(self) -> List[ModeResult]:
        """The three modes of the loaded batch; results on the device, in
        the tails' outputs (overwritten by the next run)."""
        out = []
        for j in range(3):
            head, chunk, tail = self._steps(j)
            head()
            live = self.live[j]

            def step(state):
                chunk()  # updates `state` in place
                return state

            if live["gated"]:
                _gated_loop(step, live["state"], live["n_iters"])
            else:
                chunk()
            out.append(tail())
        return out


class MSCServeEngine:
    """Batched MSC serving on one device or a mesh of ranks.

    cfg: MSCConfig shared by every request.
    max_batch: microbatch size B; every dispatch carries exactly B slots.
    bucket_quantum: dims round up to multiples of this.
    dtype: request tensor dtype at the engine boundary (the precision
      policy stays cfg.precision).
    device: where requests are packed and solved on one device (`cuda` by
      default, through CUDA graphs; `cpu` runs the same steps eagerly,
      with the kernels' plain versions); on a mesh, the rank's.
    relayout: one of core.parallel.RELAYOUTS (all one local transpose on
      one device), or "auto": per bucket, `roofline.choose_relayout` on
      the device's spec; cfg.epilogue="auto" resolves alongside
      (`core.parallel._resolve_auto`, at the bucket's first dispatch).
    mesh: a flat-schedule DeviceMesh (`launch/mesh.py:make_msc_mesh`, or
      any mesh whose dims other than "inner" make a composite slice
      role), or None for one device.

    `run(tensors)` is the whole API: third-order tensors (torch or numpy)
    in, per-request host-side MSCResults at their true sizes out, in
    order.  `close()` releases the buckets' buffers and graphs.
    """

    def __init__(self, cfg: MSCConfig, *, max_batch: int = 8,
                 bucket_quantum: int = 8, dtype=torch.float32,
                 device="cuda", relayout: str = "gspmd", mesh=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        check_relayout(relayout)
        self.cfg = cfg
        self.mesh = mesh
        self.max_batch = int(max_batch)
        self.dtype = dtype
        self.relayout = relayout
        self.device = _mesh_device(mesh, device)
        self._sched = _flat_schedule(cfg, mesh)
        # "auto" anywhere: each bucket resolves its own (cfg, relayout) once
        self._auto = relayout == "auto" or cfg.epilogue == "auto"
        self._quantum = _bucket_quantum(bucket_quantum, self._sched)
        self._programs: Dict[Tuple[int, int, int], _BucketProgram] = {}
        self._stats = ServeStats()

    def bucket_of(self, shape: Sequence[int]) -> Tuple[int, int, int]:
        """Bucket = each dim rounded up to the engine quantum."""
        return _bucket_of(shape, self._quantum)

    @property
    def stats(self) -> ServeStats:
        return self._stats

    @property
    def graphs(self) -> int:
        """CUDA graphs the engine holds (0 on the CPU)."""
        return sum(p.graphs for p in self._programs.values())

    def memory_reckoning(self) -> Tuple[int, int]:
        """(bytes of the buckets' static buffers, bytes their captures
        added to the graph pools): a live engine holds no more device
        memory than the two together."""
        return (sum(p.static_bytes for p in self._programs.values()),
                sum(p.pool_bytes for p in self._programs.values()))

    def close(self) -> None:
        """Release every bucket's buffers and graphs (a later `run`
        captures anew)."""
        for prog in self._programs.values():
            prog.release()
        self._programs.clear()

    def run(self, tensors: Sequence) -> List[MSCResult]:
        """Serve a batch of independent MSC requests.

        Groups requests by bucket, packs each group into max_batch-sized
        microbatches (the remainder filled with inert filler) and runs
        one dispatch per microbatch.  Returns one trimmed host-side
        MSCResult per input tensor, in input order.
        """
        results: List[Optional[MSCResult]] = [None] * len(tensors)
        groups: Dict[Tuple[int, int, int], List[int]] = defaultdict(list)
        for i, t in enumerate(tensors):
            groups[self.bucket_of(np.shape(t))].append(i)
        for bucket, idxs in groups.items():
            for start in range(0, len(idxs), self.max_batch):
                chunk = idxs[start:start + self.max_batch]
                self._dispatch(bucket, chunk, tensors, results)
        return results  # type: ignore[return-value]

    def _dispatch(self, bucket, chunk, tensors, results):
        prog = self._programs.get(bucket)
        if prog is None:
            sched, relayout = self._sched, self.relayout
            if self._auto:
                cfg, relayout = _resolve_auto(self.cfg, bucket, relayout,
                                              self.mesh, B=self.max_batch,
                                              device=self.device)
                sched = _flat_schedule(cfg, self.mesh)
            prog = self._programs[bucket] = _BucketProgram(
                sched, bucket, self.max_batch, self.dtype, self.device,
                relayout)
        compiles = prog.compiles
        dims = prog.load([tensors[i] for i in chunk])
        modes = prog.run()
        compiles = prog.compiles - compiles
        self._stats = dataclasses.replace(
            self._stats,
            compiles=self._stats.compiles + compiles,
            exec_cache_hits=self._stats.exec_cache_hits + (not compiles),
            requests=self._stats.requests + len(chunk),
            dispatches=self._stats.dispatches + 1,
            filler_slots=self._stats.filler_slots + self.max_batch
            - len(chunk))
        host = _to_host(modes)  # the dispatch's host reads
        for s, i in enumerate(chunk):
            results[i] = _trim_request(host, s, tuple(int(x)
                                                      for x in dims[s]))


def _to_host(modes) -> MSCResult:
    """A bucket's batched device results on the host: CPU tensors, and
    the counts as lists of Python ints."""
    return MSCResult(modes=tuple(
        ModeResult(mask=mr.mask.cpu(), d=mr.d.cpu(), lambdas=mr.lambdas.cpu(),
                   n_iters=mr.n_iters.tolist(),
                   power_iters_run=mr.power_iters_run.tolist())
        for mr in modes))


def _trim_request(host: MSCResult, s: int, shape) -> MSCResult:
    """Request s's true-size results out of the bucket-padded batched
    result (host tensors: no device work)."""
    modes = []
    for j, res in enumerate(host.modes):
        m = shape[j]
        modes.append(ModeResult(
            mask=res.mask[s, :m], d=res.d[s, :m], lambdas=res.lambdas[s, :m],
            n_iters=res.n_iters[s], power_iters_run=res.power_iters_run[s]))
    return MSCResult(modes=tuple(modes))


# ------------------------------------------------------------ continuous

def _control(perm, take_new, new_done, dims, new_dims, use_warm=None,
             use_resume=None, resume_iters=None, resume_done=None
             ) -> np.ndarray:
    """The refill's host inputs as one (B, 17) int32 array (the warm and
    resume columns zero when not given)."""
    b = len(perm)
    zero1, zero3 = np.zeros(b), np.zeros((b, 3))
    cols = [np.stack([perm, take_new, new_done], axis=1), dims, new_dims,
            np.stack([zero1 if use_warm is None else use_warm,
                      zero1 if use_resume is None else use_resume], axis=1),
            zero3 if resume_iters is None else resume_iters,
            zero3 if resume_done is None else resume_done]
    return np.concatenate(cols, axis=1).astype(np.int32)


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (the engine's boundary dtype)."""
    return np.dtype(str(dtype).replace("torch.", ""))


class _SlotState:
    """The device side of one bucket's slot table, and its two programs.

    Holds the plan's blocks and carries; `ops[j]`, block j in the
    precision policy's dtype, which the chunk step reads (the block
    itself where the dtypes agree, else a copy the refill rewrites after
    every repack: a copy taken once would go stale at the first refill);
    the staging blocks admitted requests are written to; the warm-start
    and resume staging (`warm`: per mode (B, m', c) iterates; `res_lam`,
    `res_resid`: (B, m')), written in place for a warm or resumed
    admission and zero otherwise; `ctl`, the refill's host inputs
    (`_control`), written as one copy before each refill; and
    `finished`, the step's per-slot verdicts.  Every tensor keeps its
    address for the table's life, so the programs, once built (`build`:
    captured as two CUDA graphs in one memory pool on a card, called
    eagerly on the CPU), run on it in place: a cold, warm or resumed
    refill, or a restored table, replays the same graph.  The autotuner
    builds each candidate plan's programs on one state in turn (`bind`,
    `build`, `replay_seconds`), each in a graph pool of its own, and binds
    the winner's back: the table then captures nothing.
    """

    def __init__(self, plan: MSCChunkPlan, bucket, slots: int, dtype,
                 device: torch.device):
        self.plan = plan
        self.bucket = tuple(bucket)
        self.device = device
        self.blocks, self.carries = plan.init_state(bucket, slots, dtype)
        cdt = compute_dtype(plan.sched.cfg.precision)
        self.ops = tuple(b if b.dtype == cdt else b.to(cdt)
                         for b in self.blocks)
        self.stage = tuple(torch.zeros_like(b) for b in self.blocks)
        f32 = dict(dtype=torch.float32, device=device)
        self.warm = tuple(torch.zeros(sh, **f32)
                          for sh in plan.warm_shapes(bucket, slots))
        self.res_lam = tuple(torch.zeros(sh, **f32)
                             for sh in plan.resume_shapes(bucket, slots))
        self.res_resid = tuple(torch.zeros_like(t) for t in self.res_lam)
        self.staged = False  # warm / resume rows written since zeroed
        fill = np.tile(np.int32(_FILLER_DIMS), (slots, 1))
        # neutral inputs: the warm-up before a capture changes no state
        self.ctl = torch.from_numpy(_control(
            np.arange(slots), np.zeros(slots), np.ones(slots), fill,
            fill)).to(device)
        self.finished = torch.zeros(slots, dtype=torch.bool, device=device)
        self.bind(plan)

    def bind(self, plan: MSCChunkPlan, programs=None, pool=None) -> None:
        """Run `plan`'s two programs on this state: `programs` already built
        for it on this state (in `pool`), or, without, the ones the next
        `build` makes in a new pool.  The autotuner binds each candidate
        plan in turn and the winner's programs back; every plan of a
        bucket has the same state shapes."""
        self.plan = plan
        self._step_prog = plan.build_step()
        self._refill_prog = plan.build_refill()
        self.programs: Optional[Tuple[Step, Step]] = programs
        if programs is None:
            pool = (torch.cuda.graph_pool_handle()
                    if self.device.type == "cuda" else None)
        self.pool = pool

    def _step(self) -> None:
        _, fin = self._step_prog(self.ops, self.carries)
        self.finished.copy_(fin)

    def _refill(self) -> MSCResult:
        ctl = self.ctl
        _, _, res = self._refill_prog(
            self.blocks, self.carries, ctl[:, 3:6], self.stage, ctl[:, 6:9],
            ctl[:, 1], ctl[:, 2], ctl[:, 0], self.warm, ctl[:, 9],
            self.res_lam, self.res_resid, ctl[:, 11:14], ctl[:, 14:17],
            ctl[:, 10])
        self._sync_ops()
        return res

    def _sync_ops(self) -> None:
        for op, block in zip(self.ops, self.blocks):
            if op is not block:
                op.copy_(block)

    def build(self) -> int:
        """Build the step and refill programs; returns the compiles to
        count: the graphs captured on a card, 2 on the CPU (where the
        reference compiles its two executables)."""
        fns = (self._step, self._refill)
        warm_up(fns, self.device)
        self.programs = tuple(Step(fn, self.device, self.pool) for fn in fns)
        if self.device.type == "cuda":
            return sum(st.captured for st in self.programs)
        return len(fns)

    def release(self) -> None:
        """Drop the programs and their graphs: the pool's memory goes back
        now, not when the engine is dropped."""
        self.programs = None

    def replay_seconds(self, reps: int = 3) -> float:
        """Seconds of one step and one refill, as the engine runs them on
        this state: one warm-up, then the median of `reps` (CUDA events
        around the two replays on a card, the host clock on the CPU).  The
        refill's inputs stay neutral (`ctl`: no admission, every slot
        kept), so the state is left as it was."""
        step, refill = self.programs
        step()
        refill()
        secs = []
        for _ in range(reps):
            if self.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                step()
                refill()
                end.record()
                end.synchronize()
                secs.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                step()
                refill()
                secs.append(time.perf_counter() - t0)
        return sorted(secs)[len(secs) // 2]

    def admit_write(self, s: int, tensor: torch.Tensor) -> None:
        """Write this rank's block of one admitted request's three
        unfoldings, zero-padded, over staging row s (the whole unfoldings
        on one device)."""
        x = tensor.to(self.device, self.blocks[0].dtype)
        for j, st in enumerate(self.stage):
            st[s].copy_(self.plan.local_block(j, x, st.shape[1:]))

    def clear_staging(self) -> None:
        """Zero the warm and resume staging once a refill has read it (or
        a failed one left it written)."""
        if self.staged:
            for t in (*self.warm, *self.res_lam, *self.res_resid):
                t.zero_()
            self.staged = False

    def write_warm(self, s: int, vectors) -> None:
        """A near-hit donor's true-size (m_j, c_j) iterates into warm
        staging row s, zero-padded."""
        for j, v in enumerate(vectors):
            v = torch.as_tensor(np.asarray(v, np.float32))
            self.warm[j][s, :v.shape[0], :v.shape[1]].copy_(v)
        self.staged = True

    def import_slot(self, s: int, carries, resume_iters, resume_done
                    ) -> None:
        """A parked request's exported per-mode state into staging row s:
        v into the warm staging (taken verbatim under use_resume), λ and
        the residuals into the resume staging, the sweep counts and
        verdicts into the host arrays `resume_iters` / `resume_done`
        (B, 3) of the next refill.  Padded rows stay zero, as they are in
        a slot that has run a chunk."""
        for j, host in enumerate(carries):
            v = torch.as_tensor(np.asarray(host.v, np.float32))
            m = v.shape[0]
            self.warm[j][s, :m, :v.shape[1]].copy_(v)
            self.res_lam[j][s, :m].copy_(
                torch.as_tensor(np.asarray(host.lam, np.float32)))
            self.res_resid[j][s, :m].copy_(
                torch.as_tensor(np.asarray(host.resid, np.float32)))
            resume_iters[s, j] = int(host.iters)
            resume_done[s, j] = bool(host.done)
        self.staged = True

    def refill(self, perm, take_new, new_done, dims, new_dims, use_warm,
               use_resume, resume_iters, resume_done) -> MSCResult:
        """One refill: the inputs in one copy, then the program.  The
        results (device tensors) are overwritten by the next refill."""
        self.ctl.copy_(torch.from_numpy(_control(
            perm, take_new, new_done, dims, new_dims, use_warm, use_resume,
            resume_iters, resume_done)))
        return self.programs[1]()

    def step(self) -> np.ndarray:
        """One chunk step; returns the finished flags, read on the host."""
        self.programs[0]()
        return self.finished.cpu().numpy().copy()

    def load(self, blocks, carries) -> None:
        """Write restored blocks and carries into the table's buffers (at
        their addresses: the programs stay valid)."""
        for dst, src in zip(self.blocks, blocks):
            dst.copy_(src)
        for dst, src in zip(self.carries, carries):
            for f in dataclasses.fields(SolveState):
                getattr(dst, f.name).copy_(getattr(src, f.name))
        self._sync_ops()

    def reset(self) -> None:
        """Every slot inert and every buffer zero, in place."""
        for t in (*self.blocks, *self.stage):
            t.zero_()
        for carry in self.carries:
            for t in (carry.v, carry.lam, carry.resid, carry.iters):
                t.zero_()
            carry.done.fill_(True)
        self.staged = True
        self.clear_staging()
        self._sync_ops()

    @property
    def static_bytes(self) -> int:
        ts = {id(t): t for t in (*self.blocks, *self.ops, *self.stage,
                                 *self.warm, *self.res_lam, *self.res_resid,
                                 self.ctl, self.finished)}
        for carry in self.carries:
            for f in dataclasses.fields(SolveState):
                t = getattr(carry, f.name)
                ts[id(t)] = t
        return sum(t.numel() * t.element_size() for t in ts.values())

    @property
    def pool_bytes(self) -> int:
        return sum(st.pool_bytes for st in self.programs or ())

    @property
    def graphs(self) -> int:
        return sum(st.captured for st in self.programs or ())


class _SlotTable:
    """Per-bucket slot table of the continuous engine: its device state
    (`_SlotState`), the host-side slot→request map and per-slot sizes,
    the per-class admission queues, the parked (preempted-to-host)
    requests, the admitted tensors (kept where the caller put them: the
    checkpoints, the fallback and a preemption read them), per-slot
    scheduler state (priority, deadline tick, chunks run while
    resident), the last chunk's finished flags, the cross-bucket credit
    and the recovery state.  Pure bookkeeping; the policy lives in the
    engine."""

    def __init__(self, bucket, slots: int, state: Optional[_SlotState]):
        self.bucket = bucket
        self.state = state
        self.slot_req: List[Optional[int]] = [None] * slots
        self.dims = np.tile(np.int32(_FILLER_DIMS), (slots, 1))
        # per-class FIFO queues of (rid, submit_tick, deadline_tick), -1
        # for no deadline; class 0 most urgent
        self.queues: Dict[int, Deque[Tuple[int, int, int]]] = {}
        self.chunk = 0
        self.fin = np.zeros(slots, bool)  # the last chunk's finished flags
        self.prio = np.zeros(slots, np.int32)
        self.deadline = np.full(slots, -1, np.int64)
        self.progress = np.zeros(slots, np.int64)
        # rid → dict(arr, carries (host SolveState per mode), priority,
        # deadline, warm_meta, progress)
        self.parked: Dict[int, Dict] = {}
        self.arrs: List[Optional[torch.Tensor]] = [None] * slots
        # the donor's sweeps per mode of a warm-started slot, until its
        # eviction settles `warm_sweeps_saved`
        self.warm_meta: List[Optional[Tuple[int, int, int]]] = [None] * slots
        self.credit = 0.0  # cross-bucket device-time credit
        self.retries = 0
        self.retry_at = 0.0

    def queue_for(self, priority: int) -> Deque[Tuple[int, int, int]]:
        return self.queues.setdefault(int(priority), deque())

    def queue_len(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def queued(self) -> List[Tuple[int, int, int, int]]:
        """(priority, rid, submit_tick, deadline) in per-class pop order,
        classes ascending."""
        out = []
        for pr in sorted(self.queues):
            out.extend((pr,) + e for e in self.queues[pr])
        return out

    def pop_best(self, tick: int, aging_chunks: int):
        """Pop the head with the lowest effective priority class −
        wait/aging_chunks (weighted aging: a queued request gains one
        class per aging_chunks ticks waited).  FIFO within a class; the
        more urgent class wins an exact tie.  Returns (priority, rid,
        submit_tick, deadline) or None."""
        best = None
        for pr in sorted(self.queues):
            q = self.queues[pr]
            if not q:
                continue
            eff = pr - (tick - q[0][1]) / max(1, aging_chunks)
            if best is None or eff < best[0]:
                best = (eff, pr)
        if best is None:
            return None
        pr = best[1]
        rid, sub, dl = self.queues[pr].popleft()
        return pr, rid, sub, dl

    def snapshot(self) -> tuple:
        """The bookkeeping a refill changes before its dispatch."""
        return (list(self.slot_req), list(self.arrs), self.dims.copy(),
                self.fin.copy(),
                {pr: deque(q) for pr, q in self.queues.items()},
                list(self.warm_meta), dict(self.parked), self.prio.copy(),
                self.deadline.copy(), self.progress.copy())

    def roll_back(self, snap: tuple) -> None:
        (self.slot_req, self.arrs, self.dims, self.fin, self.queues,
         self.warm_meta, self.parked, self.prio, self.deadline,
         self.progress) = snap

    def clear(self) -> None:
        """Every slot free (the queues and parked requests stay)."""
        slots = len(self.slot_req)
        self.slot_req = [None] * slots
        self.arrs = [None] * slots
        self.dims = np.tile(np.int32(_FILLER_DIMS), (slots, 1))
        self.fin = np.zeros(slots, bool)
        self.warm_meta = [None] * slots
        self.prio = np.zeros(slots, np.int32)
        self.deadline = np.full(slots, -1, np.int64)
        self.progress = np.zeros(slots, np.int64)

    @property
    def live(self) -> int:
        return sum(r is not None for r in self.slot_req)

    @property
    def free(self) -> List[int]:
        return [s for s, r in enumerate(self.slot_req) if r is None]

    def has_work(self) -> bool:
        return self.queue_len() > 0 or self.live > 0


class MSCContinuousEngine:
    """Continuous-batching MSC serving on one device or a mesh of ranks:
    the MSC counterpart of an LM engine's decode loop
    (`repro/serving/msc_engine.py`).

    Where `MSCServeEngine` runs a microbatch to completion (its slowest
    request holds all B slots, and new arrivals wait for the next
    microbatch), this engine works in gate chunks.  Each `step()` is one
    scheduler tick: the refill program evicts the slots the last chunk
    finished (finalizing their results from the frozen iterates),
    repacks the live slots and admits queued requests into the freed
    ones; then the step program advances every slot's three modes by
    `chunks_per_step` gate chunks.  Two programs per bucket
    (`MSCChunkPlan`), captured on a card as two CUDA graphs in one graph
    pool: a warm bucket captures nothing, whatever the arrival,
    eviction, placement, warm-start, preemption or restore sequence.  A
    capture that fails raises.  On the CPU, which the caller asks for
    explicitly, the same programs run eagerly.  On a mesh (`mesh=`, as
    `MSCServeEngine`'s) each rank holds its blocks of every slot's
    unfoldings and its rows of the carries, and makes the same decisions
    as every other rank: they read only the step's finished flags (from
    the all-reduced gate), the refill's gathered results and values
    gathered for them (a preempted slot's carries, the cache's iterates,
    a checkpoint's carries: every rank calls those collectives in the
    same order); rank 0's clock times the retries' backoff.

    The reference's knobs:
      refill_min_free, max_queue_chunks (the per-class starvation bound
        on the engine's clock), placement ("compact" | "stable"),
        chunks_per_step (an int, or "auto": per bucket,
        `roofline.choose_chunk_steps` over the measured sweep histogram);
      "auto" config: cfg.epilogue="auto" resolves per bucket
        (`roofline.choose_epilogue`), on the device's spec
        (`roofline.target_hw`: H100 on a card, the reference's V5E on the
        CPU);
      autotune (or an `autotune_cache`, `core/autotune.py:AutotuneCache`;
        by default persisted under `<checkpoint_dir>/autotune` when
        checkpointing is on): per bucket, at its table's creation, the
        power kernel's routes (`autotune.route_candidates`) and the
        models' proposals (a non-default epilogue; `inner_overlap` on an
        inner dim) are each built as the bucket's two programs on the
        table's state and timed by replay (one warm-up, the median of 3);
        the default wins near-ties, each loser's graphs are dropped as
        soon as it cannot win, and the winner's are the table's, so a
        searched bucket captures nothing more.  On a mesh rank 0's times
        decide for every rank.  `autotune_searches` and
        `autotune_cache_hits` count the resolutions; a search counts
        2 x candidates `compiles`;
      SLO scheduler: priority classes per `submit`, drained under
        weighted aging (`aging_chunks`); `deadline_chunks` per request
        (misses counted, results still delivered); `slo_chunks` sheds a
        submit (`LoadShedError`) whose predicted wait
        (`roofline.expected_queue_wait` over the measured sweep
        histogram) exceeds it; `preempt` (default on) parks at most one
        slot a tick on the host when a strictly more urgent request
        waits and no slot frees: the lower-priority slot with the most
        predicted remaining sweeps (`power_iter.predict_remaining_sweeps`),
        if more than `preempt_min_remaining_chunks`; it is re-queued at
        the front of its class and resumed through the refill's resume
        inputs, bit for bit; `bucket_policy` "weighted" runs one bucket a
        tick by queue-depth credit, "all" every bucket;
      result cache: `result_cache` (`serving/result_cache.py`) is probed
        in `submit` before the load-shed gate, with a key of the tensor's
        bytes cast to the engine's dtype on the host (a device-to-host
        copy for a tensor on a card); a hit is answered at the next
        `step()` without touching the device.  Every request served is
        inserted at eviction, with its frozen iterates and sketch
        (`warm_start`), so near-duplicates (tier 2) start from them
        through the refill's warm inputs;
      fault tolerance: `checkpoint_dir` with `ckpt_every_chunks` and
        `keep_checkpoints` (rank 0 writes on a mesh, the others wait at a
        barrier), `restore()` onto any device or mesh; `fault_injector`
        (`serving/faults.py`) around every dispatch, `max_retries`
        consecutive retries with exponential backoff
        (`retry_backoff_s`, `retry_backoff_max_s`), submits shed while a
        bucket recovers, then `msc_sequential` on the engine's device
        for every live and queued request of the bucket.  A failed
        refill rolls back the host bookkeeping it did before its
        dispatch.
    `donate_buffers` is accepted for the reference's checkpoints: the
    slot state is always updated in place.  `replicate_outputs` is the
    reference's flag for a mesh that spans processes (the multi-host
    control plane, `launch/distributed.py`, sets it).  Here every rank is
    a process of its own, so what the host reads is the same on every
    rank already; the flag carries the reference's policy: `preempt` is
    forced off, the evicted slots' iterates are not captured for warm
    starts, and the plan records it.  `_export_split` gives the
    control plane's two-phase checkpoint its payload: each rank's rows of
    the carries, straight from its device.

    `submit()` + `step()` are the decode loop for streaming arrivals
    (`launch/msc_serve.py --continuous`); `run(tensors)` serves a closed
    set.  Results come back on the host, trimmed to each request's size.
    `memory_reckoning()` gives the bytes a live engine holds; `close()`
    releases every table (and drops queued and in-flight requests).
    """

    def __init__(self, cfg: MSCConfig, *, slots: int = 8,
                 bucket_quantum: int = 8, dtype=torch.float32,
                 device="cuda", chunks_per_step=1, refill_min_free: int = 1,
                 max_queue_chunks: int = 8, placement: str = "compact",
                 checkpoint_dir: Optional[str] = None,
                 ckpt_every_chunks: int = 8, keep_checkpoints: int = 3,
                 max_retries: int = 3, retry_backoff_s: float = 0.05,
                 retry_backoff_max_s: float = 2.0, fault_injector=None,
                 result_cache=None, warm_start: bool = False,
                 autotune: bool = False, autotune_cache=None,
                 donate_buffers: bool = True,
                 preempt: bool = True,
                 preempt_min_remaining_chunks: int = 2,
                 aging_chunks: int = 16, slo_chunks: Optional[int] = None,
                 bucket_policy: str = "weighted", mesh=None,
                 replicate_outputs: bool = False):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if placement not in ("compact", "stable"):
            raise ValueError(f"unknown placement {placement!r}; "
                             f"expected 'compact' or 'stable'")
        if bucket_policy not in ("weighted", "all"):
            raise ValueError(f"unknown bucket_policy {bucket_policy!r}; "
                             f"expected 'weighted' or 'all'")
        if cfg.power_tol <= 0.0:
            raise ValueError("continuous batching needs the adaptive gate "
                             "(cfg.power_tol > 0); without it every slot "
                             "runs to the cap and eviction never helps")
        self.cfg = cfg
        self.mesh = mesh
        self.slots = int(slots)
        self.dtype = dtype
        # clamped to the table: a threshold no drain reaches would stall
        # admission (the starvation clock only runs while chunks run)
        self.refill_min_free = min(max(1, int(refill_min_free)), self.slots)
        self.max_queue_chunks = int(max_queue_chunks)
        self.placement = placement
        # preempt-to-host parks a slot's carries on the host: off on a
        # mesh that spans processes, as in the reference
        self.preempt = bool(preempt) and not replicate_outputs
        self.preempt_min_remaining_chunks = int(preempt_min_remaining_chunks)
        self.aging_chunks = max(1, int(aging_chunks))
        self.slo_chunks = None if slo_chunks is None else int(slo_chunks)
        self.bucket_policy = bucket_policy
        # the default plan takes concrete knobs: "auto" resolves per bucket
        # (`_plan_for`); the base config stands where no bucket is in
        # scope (the fallback oracle)
        self._base_cfg = (cfg.with_(epilogue="allgather")
                          if cfg.epilogue == "auto" else cfg)
        self._chunks_param = chunks_per_step
        self._plan = MSCChunkPlan(
            self._base_cfg, 1 if chunks_per_step == "auto" else
            chunks_per_step, device=device, mesh=mesh,
            replicate_outputs=replicate_outputs)
        self.device = self._plan.device
        self._quantum = _bucket_quantum(bucket_quantum, self._plan.sched)
        self._quantum_base = int(bucket_quantum)  # mesh-independent (ckpt)
        self._tables: Dict[Tuple[int, int, int], _SlotTable] = {}
        self._pending: Dict[int, torch.Tensor] = {}
        self._next_rid = 0
        self._tick = 0  # the engine's scheduler clock
        # rolling (priority, wait) of the last 512 admissions
        self._wait_hist: Deque[Tuple[int, int]] = deque(maxlen=512)
        # realized max-mode sweeps of served requests (the scheduler's
        # histogram)
        self._sweep_hist: Deque[int] = deque(maxlen=256)
        self._stats = ServeStats()
        # fault tolerance
        self.checkpoint_dir = checkpoint_dir
        self.ckpt_every_chunks = int(ckpt_every_chunks)
        self.keep_checkpoints = int(keep_checkpoints)
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_max_s = float(retry_backoff_max_s)
        self._faults = fault_injector
        # what a reference engine would record (it donates unless an
        # injector is set); the port always updates in place
        self.donate_buffers = bool(donate_buffers) and fault_injector is None
        self._recovering: set = set()  # buckets mid-retry (sheds load)
        self._total_chunks = 0  # the checkpoints' step id
        self._chunks_since_ckpt = 0
        # result cache
        self.result_cache = result_cache
        self.warm_start = bool(warm_start)
        self._salt: Optional[str] = None
        self._ready: Dict[int, MSCResult] = {}  # tier-1 hits
        self._req_key: Dict[int, str] = {}
        self._req_sketch: Dict[int, np.ndarray] = {}
        self._warm_pending: Dict[int, object] = {}  # rid → NearHit
        # autotune and "auto" config
        self.autotune_cache = autotune_cache
        if autotune and autotune_cache is None:
            self.autotune_cache = AutotuneCache(
                persist_dir=os.path.join(checkpoint_dir, "autotune")
                if checkpoint_dir else None)
        self._autotune = self.autotune_cache is not None
        self._bucket_plans: Dict[Tuple[int, int, int], MSCChunkPlan] = {}
        # the state a search built the winner's programs on, until the
        # bucket's table takes it; the tables whose programs a search built
        self._tuned: Dict[Tuple[int, int, int], _SlotState] = {}
        self._tuned_fresh: set = set()

    def bucket_of(self, shape: Sequence[int]) -> Tuple[int, int, int]:
        """Bucket = each dim rounded up to the engine quantum."""
        return _bucket_of(shape, self._quantum)

    @property
    def stats(self) -> ServeStats:
        return self._stats

    @property
    def graphs(self) -> int:
        """CUDA graphs the engine holds (0 on the CPU)."""
        return sum(tb.state.graphs for tb in self._tables.values())

    def memory_reckoning(self) -> Tuple[int, int]:
        """(bytes of the slot tables' static buffers, bytes their captures
        added to the graph pools): a live engine holds no more device
        memory than the two together.  The static buffers are, per
        bucket, the blocks, the staging blocks and the operand copies
        (under bf16_fp32) of three unfoldings of B slots, the warm and
        resume staging and the carries; the pools hold the programs'
        temporaries, among them the refill's gather scratch (one
        block)."""
        return (sum(tb.state.static_bytes for tb in self._tables.values()),
                sum(tb.state.pool_bytes for tb in self._tables.values()))

    def class_waits(self) -> Dict[int, Dict[str, float]]:
        """Per priority class, the count and the p50 / p99 of the queue
        waits (ticks) of the last 512 admissions."""
        by: Dict[int, List[int]] = defaultdict(list)
        for pr, w in self._wait_hist:
            by[int(pr)].append(w)
        return {pr: {"n": len(ws),
                     "p50": float(np.percentile(np.asarray(ws, float), 50)),
                     "p99": float(np.percentile(np.asarray(ws, float), 99))}
                for pr, ws in sorted(by.items())}

    def close(self) -> None:
        """Release every slot table and its graphs; queued, parked and
        in-flight requests are dropped."""
        for tb in self._tables.values():
            tb.state.release()
        self._tables.clear()
        self._pending.clear()
        self._ready.clear()
        self._req_key.clear()
        self._req_sketch.clear()
        self._warm_pending.clear()

    def _bump(self, **deltas) -> None:
        self._stats = dataclasses.replace(
            self._stats, **{k: getattr(self._stats, k) + v
                            for k, v in deltas.items()})

    def note_ft_event(self, **deltas) -> None:
        """Bump fault-tolerance counters an outer control plane owns (the
        multi-host driver, `launch/distributed.py`: heartbeats missed,
        host losses, reinits, shard files written)."""
        self._bump(**deltas)

    def _table(self, bucket) -> _SlotTable:
        tb = self._tables.get(bucket)
        if tb is None:
            plan = self._plan_for(bucket)
            state = self._tuned.pop(bucket, None)
            if state is None:
                state = _SlotState(plan, bucket, self.slots, self.dtype,
                                   self.device)
            tb = self._tables[bucket] = _SlotTable(bucket, self.slots, state)
        return tb

    def _executables(self, tb: _SlotTable) -> None:
        """The bucket's two programs, built on its first tick (a search
        built and counted them already)."""
        if tb.state.programs is None:
            self._bump(compiles=tb.state.build())
        elif tb.bucket in self._tuned_fresh:
            self._tuned_fresh.discard(tb.bucket)
        else:
            self._bump(exec_cache_hits=1)

    # ---- per-bucket "auto" config and the autotuner ---------------------
    def _resolve_bucket(self, bucket) -> Tuple[MSCConfig, int]:
        """(cfg, chunks_per_step) of one bucket: the roofline choosers, on
        the device's spec, fill the knobs left on "auto"; the others pass
        through."""
        from repro_torch.roofline import (choose_chunk_steps,
                                          choose_epilogue, eigensolve_model,
                                          target_hw)

        hw = target_hw(self.device)
        cfg = self._base_cfg
        p = self._plan.sched.slice_shards
        q = self._plan.sched.inner_shards
        check = max(cfg.power_check_every, 1)
        if self.cfg.epilogue == "auto":
            # mode 1 dominates the epilogue bytes on near-cube buckets;
            # the schedules take one policy
            cfg = cfg.with_(epilogue=choose_epilogue(bucket[0], bucket[2], p,
                                                     hw=hw))
        if self._autotune and q > 1 and not cfg.inner_overlap:
            m, r, c = bucket
            plain = eigensolve_model(m, r, c, p, q, sweeps=check, hw=hw)
            both = eigensolve_model(m, r, c, p, q, sweeps=check,
                                    overlap=True, hw=hw)
            if both["latency_s"] < plain["latency_s"]:
                cfg = cfg.with_(inner_overlap=True)
        chunks = self._plan.chunks_per_step
        if self._chunks_param == "auto":
            hist = list(self._sweep_hist) or [4 * check]
            chunks = choose_chunk_steps(hist, self.slots, check_every=check,
                                        shape=bucket, p=p, q=q,
                                        epilogue=cfg.epilogue, hw=hw)
        return agreed(self.mesh, (cfg, chunks))

    def _make_plan(self, cfg: MSCConfig, chunks: int,
                   power_route=None) -> MSCChunkPlan:
        if (cfg == self._base_cfg and chunks == self._plan.chunks_per_step
                and power_route is None):
            return self._plan
        return MSCChunkPlan(cfg, chunks, device=self.device, mesh=self.mesh,
                            power_route=power_route,
                            replicate_outputs=self._plan.replicate_outputs)

    def _mesh_items(self) -> Tuple[Tuple[str, int], ...]:
        """The mesh's (dim, size) items, (("slice", 1),) on one device."""
        from repro_torch.launch.mesh import mesh_dims

        if self.mesh is None:
            return (("slice", 1),)
        return tuple((a, int(s)) for a, s in mesh_dims(self.mesh).items())

    def _tune_blocks(self, bucket, cfg: MSCConfig, chunks: int):
        """Resolve the bucket's power-kernel route, and validate the
        models' proposals, through the autotune cache.  Returns (cfg,
        power_route, state): the tuned config, the winning route (None:
        the kernel's own pick) and, after a live search, the state the
        winner's programs were built on (the table takes it).

        A live search builds each candidate as the bucket's two programs
        (captured as two CUDA graphs on a card) on one scratch state and
        times them by replay (`_SlotState.replay_seconds`).  When
        `_resolve_bucket` proposed a non-default epilogue or
        inner_overlap, both variants are candidates, the base first: the
        model proposes, the measurement disposes, and the default wins
        near-ties (`VALIDATE_MARGIN`).  Block knobs the caller pinned with
        no proposal to validate leave nothing to search, as in the
        reference."""
        from repro_torch.core import autotune as at

        base = self._base_cfg
        variants = [cfg]
        if (cfg.epilogue != base.epilogue
                or cfg.inner_overlap != base.inner_overlap):
            variants = [cfg.with_(epilogue=base.epilogue,
                                  inner_overlap=base.inner_overlap), cfg]
        pinned = (cfg.block_r is not None and cfg.block_i is not None
                  and cfg.block_j is not None)
        if pinned and len(variants) == 1:
            return cfg, None, None
        ac = self.autotune_cache
        key = at.autotune_key(bucket + (self.slots,), self._mesh_items(),
                              _np_dtype(self.dtype), cfg, salt=ac.salt)
        blocks = {k: v if getattr(cfg, k) is None else getattr(cfg, k)
                  for k, v in at.DEFAULT_BLOCKS.items()}
        # passes over T in a launch: the gate chunk's sweeps, or one where
        # an inner dim runs each sweep as a `power_matvec`
        passes = (1 if self._plan.sched.inner_shards > 1
                  else max(1, min(cfg.power_check_every, cfg.power_iters)))
        routes = at.route_candidates(
            bucket, compute_dtype(cfg.precision),
            cfg.use_kernels and self.device.type == "cuda", passes)
        cands = [dict(r, **blocks, epilogue=v.epilogue,
                      inner_overlap=v.inner_overlap)
                 for v in variants for r in routes]
        searches0 = ac.searches
        state: Optional[_SlotState] = None
        built = 0

        def measure(cand):
            nonlocal state, built
            plan = self._make_plan(
                cfg.with_(**{k: v for k, v in cand.items()
                             if k != "power_route"}), chunks,
                cand["power_route"])
            if state is None:
                state = _SlotState(plan, bucket, self.slots, self.dtype,
                                   self.device)
            else:
                state.bind(plan)
            built += state.build()
            secs = state.replay_seconds()
            if self.mesh is not None:
                import torch.distributed as dist

                box = [secs]  # rank 0's times decide on every rank
                dist.broadcast_object_list(box, src=0)
                secs = float(box[0])
            return secs, (plan, state.programs, state.pool)

        margin = (at.VALIDATE_MARGIN if len(variants) > 1
                  else at.DEFAULT_MARGIN)
        agreed(self.mesh, key in ac)  # every rank searches, or none
        knobs, payload = ac.resolve(key, cands, measure, margin=margin)
        route = knobs.pop("power_route", None)
        tuned = cfg.with_(**knobs)
        if ac.searches == searches0:
            self._bump(autotune_cache_hits=1)
            return tuned, route, None
        self._bump(autotune_searches=1, compiles=built)
        if self._rank0():
            ac.persist()
        state.bind(*payload)  # the winner's programs; the losers' are gone
        state.reset()
        self._tuned_fresh.add(bucket)
        return tuned, route, state

    def _plan_for(self, bucket) -> MSCChunkPlan:
        """The bucket's resolved chunk plan (cached): the base plan when
        nothing resolves differently, else one built from the bucket's
        "auto" config and autotuned route."""
        plan = self._bucket_plans.get(bucket)
        if plan is None:
            cfg, chunks = self._resolve_bucket(bucket)
            route = None
            if self._autotune:
                cfg, route, state = self._tune_blocks(bucket, cfg, chunks)
                if state is not None:
                    self._tuned[bucket] = state
                    plan = state.plan
            if plan is None:
                plan = self._make_plan(cfg, chunks, route)
            self._bucket_plans[bucket] = plan
        return plan

    def _rank0(self) -> bool:
        if self.mesh is None:
            return True
        import torch.distributed as dist

        return dist.get_rank() == 0

    def _clock(self) -> float:
        """time.monotonic(); on a mesh rank 0's, so that every rank
        decides a backoff alike."""
        now = time.monotonic()
        if self.mesh is None:
            return now
        import torch.distributed as dist

        box = [now]
        dist.broadcast_object_list(box, src=0)
        return float(box[0])

    # ---- the decode loop ---------------------------------------------
    def submit(self, tensor, *, priority: int = 0,
               deadline_chunks: Optional[int] = None) -> int:
        """Queue one request (a third-order torch tensor or array, kept
        where it is and read when admitted); returns its id, the key
        `step()` returns its result under.

        priority: class >= 0, 0 most urgent; deadline_chunks: an SLO
        budget in ticks (a later finish counts a deadline miss).  Raises
        LoadShedError while a bucket recovers from a dispatch failure, or
        when `slo_chunks` is set and the request's predicted wait exceeds
        it.  A tier-1 cache hit is answered without the device (even
        while recovering)."""
        with spans.span("serve.submit"):
            if priority < 0:
                raise ValueError(f"priority must be >= 0, got {priority}")
            if deadline_chunks is not None and deadline_chunks < 1:
                raise ValueError(f"deadline_chunks must be >= 1, "
                                 f"got {deadline_chunks}")
            if not isinstance(tensor, torch.Tensor):
                tensor = torch.from_numpy(np.array(tensor))
            cache = self.result_cache
            key = arr = None
            if cache is not None:
                if self._salt is None:
                    self._salt = cache_salt()
                arr = host_array(tensor, _np_dtype(self.dtype))
                key = result_cache_key(arr, self.cfg, salt=self._salt)
                res = cache.get(key)
                if res is not None:
                    rid = self._next_rid
                    self._next_rid += 1
                    self._ready[rid] = res
                    self._bump(requests=1, cache_hits=1)
                    spans.open("serve.request", rid)
                    return rid
            if self._recovering:
                self._bump(shed_requests=1)
                raise LoadShedError(
                    f"engine is recovering from a dispatch failure on "
                    f"bucket(s) {sorted(self._recovering)}; resubmit after "
                    f"recovery")
            bucket = self.bucket_of(tuple(tensor.shape))
            tb = self._table(bucket)
            if self.slo_chunks is not None:
                pred = self._predicted_wait(tb, int(priority))
                if pred > self.slo_chunks:
                    self._bump(shed_requests=1, slo_sheds=1)
                    raise LoadShedError(
                        f"predicted queue wait {pred:.1f} chunks exceeds the "
                        f"SLO bound {self.slo_chunks} for bucket {bucket} "
                        f"(priority {priority}); resubmit later")
            rid = self._next_rid
            self._next_rid += 1
            self._pending[rid] = tensor
            deadline = (-1 if deadline_chunks is None
                        else self._tick + int(deadline_chunks))
            tb.queue_for(priority).append((rid, self._tick, deadline))
            spans.open("serve.request", rid)
            spans.open("serve.queued", rid)
            self._bump(requests=1)
            if cache is not None:
                self._bump(cache_misses=1)
                self._req_key[rid] = key
                if self.warm_start:
                    sketch = spectral_sketch(arr, r=cache.sketch_r)
                    self._req_sketch[rid] = sketch
                    hit = cache.lookup_near(sketch, arr.shape)
                    if hit is not None:
                        self._warm_pending[rid] = hit
            return rid

    def has_work(self) -> bool:
        return bool(self._ready) or any(tb.has_work()
                                        for tb in self._tables.values())

    def step(self) -> Dict[int, MSCResult]:
        """One scheduler tick: tier-1 hits answered; then under
        bucket_policy "weighted" the one bucket with the most accumulated
        queue-depth credit (among those not backing off), under "all"
        every bucket with work: admit as the policy permits, advance one
        step, evict finished slots; then a periodic checkpoint when due.
        Returns the requests that finished this tick; the engine keeps no
        copy."""
        with spans.span("serve.tick", tick=self._tick + 1):
            finished: Dict[int, MSCResult] = {}
            self._tick += 1
            if self._ready:
                finished.update(self._ready)
                self._ready.clear()
            ready = [tb for tb in self._tables.values() if tb.has_work()]
            runnable = ready
            if any(tb.retry_at for tb in ready):
                now = self._clock()
                runnable = [tb for tb in ready
                            if not tb.retry_at or now >= tb.retry_at]
            if (self.bucket_policy == "weighted" and len(ready) > 1
                    and runnable):
                # credit grows on every bucket with work, so a skipped
                # bucket's claim grows; ties break on the bucket
                for tb in ready:
                    tb.credit += tb.live + tb.queue_len()
                chosen = max(runnable, key=lambda t: (t.credit, t.bucket))
                chosen.credit = 0.0
                finished.update(self._step_table(chosen))
            else:
                for tb in ready:
                    finished.update(self._step_table(tb))
            if (self.checkpoint_dir is not None and self.ckpt_every_chunks > 0
                    and self._chunks_since_ckpt >= self.ckpt_every_chunks):
                self.checkpoint()
            for rid in finished:
                spans.close("serve.request", rid)
            return finished

    def run(self, tensors: Sequence, *,
            priorities: Optional[Sequence[int]] = None,
            deadline_chunks: Optional[Sequence[Optional[int]]] = None
            ) -> List[MSCResult]:
        """Serve a closed set of requests to completion, in order (with
        optional per-request priorities and deadlines).  Do not
        interleave with an outside submit()/step() loop: results step()
        hands out while run() drains are collected here and dropped."""
        rids = [self.submit(
            t, priority=0 if priorities is None else int(priorities[i]),
            deadline_chunks=None if deadline_chunks is None
            else deadline_chunks[i]) for i, t in enumerate(tensors)]
        got: Dict[int, MSCResult] = {}
        while self.has_work() and not all(r in got for r in rids):
            got.update(self.step())
        return [got[r] for r in rids]

    # ---- one bucket's tick --------------------------------------------
    def _should_admit(self, tb: _SlotTable, n_free: int) -> bool:
        if n_free == 0 or tb.queue_len() == 0:
            return False
        if n_free >= self.refill_min_free:
            return True
        # the starvation bound, per class per bucket on the engine's
        # clock, which runs on ticks given to other buckets too
        return any(self._tick - q[0][1] >= self.max_queue_chunks
                   for q in tb.queues.values() if q)

    def _mean_chunks(self, tb: _SlotTable) -> float:
        """Measured mean residency of a request in chunk steps (4 before
        any request is served)."""
        per = (max(1, self.cfg.power_check_every)
               * self._plan_for(tb.bucket).chunks_per_step)
        if not self._sweep_hist:
            return 4.0
        return max(1.0, float(np.mean(list(self._sweep_hist))) / per)

    def _predicted_wait(self, tb: _SlotTable, priority: int) -> float:
        """Predicted queue wait (chunks) of a new request of `priority` in
        this bucket: `roofline.expected_queue_wait`."""
        ahead = sum(len(q) for pr, q in tb.queues.items() if pr <= priority)
        return expected_queue_wait(ahead, len(tb.free), self.slots,
                                   self._mean_chunks(tb))

    def _plan_preempt(self, tb: _SlotTable, n_free: int) -> List[int]:
        """At most one slot to park this tick: only when no slot frees
        anyway, a strictly more urgent request waits, and a less urgent
        slot is predicted to hold its slot for more than
        `preempt_min_remaining_chunks` chunks; among those, the one with
        the most predicted remaining sweeps."""
        if not self.preempt or n_free > 0:
            return []
        waiting = [pr for pr, q in tb.queues.items() if q]
        if not waiting:
            return []
        urgent = min(waiting)
        k = max(1, self.cfg.power_check_every)
        per = k * self._plan_for(tb.bucket).chunks_per_step
        cap = self.cfg.power_iters
        best = None
        for s, rid in enumerate(tb.slot_req):
            if rid is None or tb.fin[s] or tb.prio[s] <= urgent:
                continue
            cur = int(tb.progress[s]) * per
            rem = predict_remaining_sweeps(self._sweep_hist, cur, cap=cap,
                                           check_every=k) / per
            if rem > self.preempt_min_remaining_chunks:
                if best is None or rem > best[0]:
                    best = (rem, s)
        return [] if best is None else [best[1]]

    def _permutation(self, tb: _SlotTable) -> np.ndarray:
        """Slot permutation of the repack (new[s] = old[perm[s]])."""
        if self.placement == "compact":
            order = ([s for s, r in enumerate(tb.slot_req) if r is not None]
                     + tb.free)
            return np.asarray(order, np.int32)
        return np.arange(self.slots, dtype=np.int32)

    def _refill(self, tb: _SlotTable, evict: List[int],
                preempt: List[int]) -> Dict[int, MSCResult]:
        """Finalize the `evict` slots, park the `preempt` slots on the
        host (re-queued at the front of their class), free both, permute
        and admit: one run of the refill program (cold, warm and resumed
        admissions alike).  Returns the evicted requests' results."""
        with spans.span("serve.refill", evicted=len(evict)) as sp:
            old_dims = tb.dims.copy()
            old_deadline = tb.deadline.copy()
            old_warm_meta = list(tb.warm_meta)
            evicted = [(s, tb.slot_req[s]) for s in evict]
            cache = self.result_cache
            state = tb.state
            # the evicted slots' frozen iterates, read before the refill
            # overwrites them, become tier-2 donors; preempted slots are not
            # read (their iterates are mid-solve), nor is anything on a mesh
            # that spans processes (the reference's policy)
            capture = None
            if (cache is not None and evicted
                    and not self._plan.replicate_outputs):
                capture = [h.v for h in self._plan.export_carries(
                    tb.bucket, state.carries)]
            for s in preempt:
                rid = tb.slot_req[s]
                tb.parked[rid] = {
                    "arr": tb.arrs[s],
                    "carries": self._plan.export_slot(tb.bucket, state.carries,
                                                      s),
                    "priority": int(tb.prio[s]),
                    "deadline": int(tb.deadline[s]),
                    "warm_meta": tb.warm_meta[s],
                    "progress": int(tb.progress[s]),
                }
                # the class's oldest work; its wait restarts now
                tb.queue_for(tb.prio[s]).appendleft(
                    (rid, self._tick, int(tb.deadline[s])))
                spans.open("serve.queued", rid)
            for s in evict + preempt:
                tb.slot_req[s] = None
                tb.arrs[s] = None
                tb.warm_meta[s] = None
                tb.prio[s] = 0
                tb.deadline[s] = -1
                tb.progress[s] = 0
            perm = self._permutation(tb)
            tb.slot_req = [tb.slot_req[p] for p in perm]
            tb.arrs = [tb.arrs[p] for p in perm]
            tb.dims = tb.dims[perm]
            tb.fin = tb.fin[perm]
            tb.warm_meta = [tb.warm_meta[p] for p in perm]
            tb.prio = tb.prio[perm]
            tb.deadline = tb.deadline[perm]
            tb.progress = tb.progress[perm]
            B = self.slots
            new_dims = np.tile(np.int32(_FILLER_DIMS), (B, 1))
            take_new = np.zeros(B, bool)
            new_done = np.ones(B, bool)
            use_warm = np.zeros(B, bool)
            use_resume = np.zeros(B, bool)
            resume_iters = np.zeros((B, 3), np.int32)
            resume_done = np.zeros((B, 3), bool)
            waits: List[Tuple[int, int]] = []
            n_resumes = 0
            state.clear_staging()
            for s in tb.free:
                entry = tb.pop_best(self._tick, self.aging_chunks)
                if entry is None:
                    break
                pr, rid, submitted, deadline = entry
                parked = tb.parked.pop(rid, None)
                if parked is not None:
                    arr = parked["arr"]
                    state.admit_write(s, arr)
                    state.import_slot(s, parked["carries"], resume_iters,
                                      resume_done)
                    use_resume[s] = True
                    tb.warm_meta[s] = parked["warm_meta"]
                    tb.progress[s] = parked["progress"]
                    n_resumes += 1
                else:
                    arr = self._pending.pop(rid)
                    state.admit_write(s, arr)
                    tb.progress[s] = 0
                    hit = self._warm_pending.pop(rid, None)
                    if hit is not None:
                        state.write_warm(s, hit.vectors)
                        use_warm[s] = True
                        tb.warm_meta[s] = hit.donor_iters
                        self._bump(warm_starts=1)
                    else:
                        tb.warm_meta[s] = None
                new_dims[s] = tuple(arr.shape)
                take_new[s] = True
                new_done[s] = False
                tb.slot_req[s] = rid
                tb.arrs[s] = arr
                tb.dims[s] = tuple(arr.shape)
                tb.fin[s] = False
                tb.prio[s] = pr
                tb.deadline[s] = deadline
                waits.append((pr, self._tick - submitted))
            sp.set(admitted=len(waits))
            results = self._invoke("refill", state.refill, perm, take_new,
                                   new_done, old_dims, new_dims, use_warm,
                                   use_resume, resume_iters, resume_done)
            for s in np.flatnonzero(take_new):  # admitted: no roll-back now
                spans.close("serve.queued", tb.slot_req[s])
            self._wait_hist.extend(waits)
            self._bump(refills=1, dispatches=1,
                       queue_wait_chunks=sum(w for _, w in waits),
                       evictions=len(evicted), preemptions=len(preempt),
                       resumes=n_resumes)
            if waits:
                vals = np.asarray([w for _, w in self._wait_hist], float)
                self._stats = dataclasses.replace(
                    self._stats,
                    queue_wait_p50_chunks=float(np.percentile(vals, 50)),
                    queue_wait_p99_chunks=float(np.percentile(vals, 99)))
            if not evicted:
                return {}
            # before the next refill reuses them
            host = _to_host(results.modes)
            out: Dict[int, MSCResult] = {}
            for s, rid in evicted:
                d = old_dims[s]
                res = _trim_request(host, s, tuple(int(x) for x in d))
                out[rid] = res
                if old_deadline[s] >= 0 and self._tick > old_deadline[s]:
                    self._bump(deadline_misses=1)
                pir = [res.modes[j].power_iters_run for j in range(3)]
                if all(x is not None for x in pir):
                    self._sweep_hist.append(max(int(x) for x in pir))
                wm = old_warm_meta[s]
                if wm is not None:
                    self._bump(warm_sweeps_saved=sum(
                        max(0, int(di) - int(res.modes[j].power_iters_run))
                        for j, di in enumerate(wm)))
                key = self._req_key.pop(rid, None)
                sketch = self._req_sketch.pop(rid, None)
                if cache is not None and key is not None:
                    vecs = None
                    if capture is not None:
                        vecs = tuple(capture[j][s, :d[j], :d[C_OF[j]]]
                                     for j in range(3))
                    cache.put(key, res, shape=tuple(int(x) for x in d),
                              vectors=vecs, sketch=sketch)
            return out

    def _step_table(self, tb: _SlotTable) -> Dict[int, MSCResult]:
        if tb.retry_at and self._clock() < tb.retry_at:
            return {}  # backing off before this bucket's next retry
        self._executables(tb)
        # evict what the last chunk finished and admit queued requests:
        # one refill covers both
        evict = [s for s in range(self.slots)
                 if tb.fin[s] and tb.slot_req[s] is not None]
        preempt = self._plan_preempt(tb, len(tb.free) + len(evict))
        out: Dict[int, MSCResult] = {}
        if (evict or preempt
                or self._should_admit(tb, len(tb.free) + len(evict))):
            # the refill changes host bookkeeping before its dispatch; a
            # failed dispatch rolls it back, so the retry plans the same
            # refill again (a fault fires before the program runs, and
            # the staging it wrote is rewritten or cleared)
            snap = (tb.snapshot(), dict(self._pending),
                    dict(self._warm_pending), dict(self._req_key),
                    dict(self._req_sketch))
            try:
                out = self._refill(tb, evict, preempt)
            except Exception as e:  # noqa: BLE001 - the recovery boundary
                tb.roll_back(snap[0])
                (self._pending, self._warm_pending, self._req_key,
                 self._req_sketch) = snap[1:]
                tb.state.clear_staging()
                return self._dispatch_failed(tb, e, out)
        if tb.live > 0:
            live = tb.live
            # refill batching can leave slots free while the bucket's
            # queue holds work
            if tb.queue_len() > 0 and len(tb.free) > 0:
                self._bump(idle_bucket_ticks=1)
            advanced = [s for s, r in enumerate(tb.slot_req)
                        if r is not None and not tb.fin[s]]
            try:
                with spans.span("serve.chunk", live=live):
                    fin = self._invoke("chunk", tb.state.step)
            except Exception as e:  # noqa: BLE001 - the recovery boundary
                return self._dispatch_failed(tb, e, out)
            tb.fin = fin
            tb.chunk += 1
            tb.progress[advanced] += 1
            self._total_chunks += 1
            self._chunks_since_ckpt += 1
            self._bump(chunk_steps=1, dispatches=1, slot_chunks=self.slots,
                       busy_slot_chunks=live)
        tb.retries = 0
        tb.retry_at = 0.0
        self._recovering.discard(tb.bucket)
        return out

    # ---- recovery -------------------------------------------------------
    def _invoke(self, kind: str, fn, *args):
        """One dispatch through the fault injector's hooks."""
        if self._faults is not None:
            self._faults.before(kind)
        result = fn(*args)
        if self._faults is not None:
            self._faults.after(kind)
        return result

    def _dispatch_failed(self, tb: _SlotTable, exc: Exception,
                         out: Dict[int, MSCResult]) -> Dict[int, MSCResult]:
        """Bounded retries with exponential backoff, then the sequential
        fallback.  `out` holds results a dispatch earlier in the tick
        already made."""
        tb.retries += 1
        if tb.retries > self.max_retries:
            warnings.warn(
                f"bucket {tb.bucket}: dispatch failed {tb.retries} "
                f"consecutive times ({exc!r}); serving its requests "
                f"through the sequential oracle")
            out.update(self._fallback_table(tb))
            return out
        self._recovering.add(tb.bucket)
        self._bump(retries=1)
        backoff = min(self.retry_backoff_s * (2 ** (tb.retries - 1)),
                      self.retry_backoff_max_s)
        tb.retry_at = self._clock() + backoff
        return out

    def _fallback_table(self, tb: _SlotTable) -> Dict[int, MSCResult]:
        """Serve every live and queued request of a sick bucket through
        `msc_sequential` on the engine's device (with the engine's
        config, kernels included), then reset the table to inert, in
        place.  Slow, but no request is lost and the bucket comes back
        healthy."""
        jobs: List[Tuple[int, torch.Tensor]] = []
        for s, rid in enumerate(tb.slot_req):
            if rid is not None:
                jobs.append((rid, tb.arrs[s]))
        for pr in sorted(tb.queues):
            q = tb.queues[pr]
            while q:
                rid, _, _ = q.popleft()
                parked = tb.parked.pop(rid, None)
                jobs.append((rid, parked["arr"] if parked is not None
                             else self._pending.pop(rid)))
        tb.parked.clear()
        out: Dict[int, MSCResult] = {}
        for rid, t in jobs:
            # the base config: the oracle takes a concrete epilogue (one
            # device ignores it)
            res = msc_sequential(t.to(self.device, self.dtype),
                                 self._base_cfg, device=self.device)
            host = MSCResult(modes=tuple(
                ModeResult(mask=r.mask.cpu(), d=r.d.cpu(),
                           lambdas=r.lambdas.cpu(), n_iters=int(r.n_iters),
                           power_iters_run=int(r.power_iters_run))
                for r in res.modes))
            out[rid] = host
            # the fallback still feeds tier 1; it has no iterates to give
            key = self._req_key.pop(rid, None)
            self._req_sketch.pop(rid, None)
            self._warm_pending.pop(rid, None)
            if self.result_cache is not None and key is not None:
                self.result_cache.put(key, host, shape=tuple(t.shape))
        tb.state.reset()
        tb.clear()
        tb.retries = 0
        tb.retry_at = 0.0
        self._recovering.discard(tb.bucket)
        self._bump(fallback_requests=len(out))
        return out

    # ---- checkpoint / restore -----------------------------------------
    def checkpoint(self) -> Optional[str]:
        """Snapshot the whole engine (every bucket's slot table, queues,
        parked requests, stats) to `checkpoint_dir` under the chunk
        count, atomically.  On a mesh every rank calls it (the carries
        are gathered); rank 0 writes while the others wait at a
        barrier."""
        if self.checkpoint_dir is None:
            return None
        if self._faults is not None:
            self._faults.before("checkpoint")
        leaves, meta = self._export()
        path = os.path.join(self.checkpoint_dir,
                            f"step_{self._total_chunks:08d}")
        if self._rank0():
            save_checkpoint(self.checkpoint_dir, self._total_chunks, leaves,
                            extra=meta)
            gc_checkpoints(self.checkpoint_dir, self.keep_checkpoints)
        if self.mesh is not None:
            import torch.distributed as dist

            # the others wait for rank 0's write: a one-element all_reduce
            # on the engine's device is the barrier, its result read on
            # the host (an NCCL all_reduce returns before it ends)
            done = torch.zeros(1, device=self.device)
            dist.all_reduce(done)
            done.item()
        self._chunks_since_ckpt = 0
        self._bump(checkpoints_written=1)
        return path

    def _export(self) -> Tuple[List[np.ndarray], Dict]:
        """Flat leaf list and JSON metadata of the whole engine, in the
        reference's order: per bucket (sorted), each mode's carry (v,
        λ, residuals, sweeps, verdicts: trimmed to the bucket's true
        slice count, gathered from every rank), then the bookkeeping
        leaves.  No device block is written: the blocks are a function
        of the admitted tensors, which are."""
        leaves: List[np.ndarray] = []
        buckets_meta = []
        for bucket in sorted(self._tables):
            tb = self._tables[bucket]
            for host in self._plan.export_carries(bucket, tb.state.carries):
                leaves.extend([host.v, host.lam, host.resid, host.iters,
                               host.done])
            leaves.extend(self._export_sched_leaves(tb))
            buckets_meta.append(self._bucket_meta(tb))
        return leaves, self._export_meta(buckets_meta)

    def _host(self, t: torch.Tensor) -> np.ndarray:
        """An admitted tensor on the host in the engine's dtype."""
        return host_array(t.detach().to(self.dtype))

    def _export_sched_leaves(self, tb: _SlotTable) -> List[np.ndarray]:
        """One bucket's bookkeeping leaves: dims, fin, slot rids, per-slot
        priority / deadline / progress, the queues as (N, 4) rows
        (priority, rid, submit_tick, deadline), the live tensors, the
        queued tensors (a parked request's from its parked copy), then
        each parked request's carries (v, λ, residuals per mode)."""
        queued = tb.queued()
        leaves = [tb.dims.astype(np.int32), np.asarray(tb.fin, np.bool_),
                  np.asarray([-1 if r is None else r for r in tb.slot_req],
                             np.int64),
                  tb.prio.astype(np.int64), tb.deadline.astype(np.int64),
                  tb.progress.astype(np.int64),
                  np.asarray(queued, np.int64).reshape(-1, 4)]
        leaves += [self._host(tb.arrs[s]) for s, r in enumerate(tb.slot_req)
                   if r is not None]
        leaves += [self._host(tb.parked[rid]["arr"] if rid in tb.parked
                              else self._pending[rid])
                   for _, rid, _, _ in queued]
        for _, rid, _, _ in queued:
            if rid in tb.parked:
                for host in tb.parked[rid]["carries"]:
                    leaves += [np.asarray(host.v), np.asarray(host.lam),
                               np.asarray(host.resid)]
        return leaves

    def _bucket_meta(self, tb: _SlotTable) -> Dict:
        live = [s for s, r in enumerate(tb.slot_req) if r is not None]
        parked_meta = []
        for _, rid, _, _ in tb.queued():
            p = tb.parked.get(rid)
            if p is not None:
                parked_meta.append({
                    "rid": int(rid), "progress": int(p["progress"]),
                    "iters": [int(h.iters) for h in p["carries"]],
                    "done": [bool(h.done) for h in p["carries"]],
                    "warm_meta": (None if p["warm_meta"] is None
                                  else [int(x) for x in p["warm_meta"]]),
                })
        return {"bucket": [int(x) for x in tb.bucket], "chunk": tb.chunk,
                "live_slots": live, "parked": parked_meta}

    def _export_meta(self, buckets_meta, **over) -> Dict:
        from repro_torch.launch.mesh import mesh_dims

        mesh = ([["slice", 1]] if self.mesh is None else
                [[a, int(s)] for a, s in mesh_dims(self.mesh).items()])
        meta = {
            "format": 1,
            "mesh": mesh,
            "slots": self.slots,
            "dtype": str(self.dtype).replace("torch.", ""),
            "cfg": dataclasses.asdict(self.cfg),
            "policy": {
                "bucket_quantum": self._quantum_base,
                "chunks_per_step": self._chunks_param,
                "autotune": self._autotune,
                "donate_buffers": self.donate_buffers,
                "refill_min_free": self.refill_min_free,
                "max_queue_chunks": self.max_queue_chunks,
                "placement": self.placement,
                "ckpt_every_chunks": self.ckpt_every_chunks,
                "keep_checkpoints": self.keep_checkpoints,
                "max_retries": self.max_retries,
                "retry_backoff_s": self.retry_backoff_s,
                "retry_backoff_max_s": self.retry_backoff_max_s,
                "preempt": self.preempt,
                "preempt_min_remaining_chunks":
                    self.preempt_min_remaining_chunks,
                "aging_chunks": self.aging_chunks,
                "slo_chunks": self.slo_chunks,
                "bucket_policy": self.bucket_policy,
            },
            "tick": self._tick,
            "next_rid": self._next_rid,
            "total_chunks": self._total_chunks,
            "stats": dataclasses.asdict(self._stats),
            "buckets": buckets_meta,
        }
        meta.update(over)
        return meta

    def _export_split(self):
        """(device, host, meta): the payload of the control plane's
        two-phase checkpoint (`checkpoint/store.py`, format 2).

        The leaf order of `_export`, but the 15 carry leaves of a bucket
        stay this rank's rows on its device, in the reference's padded
        device layout: `device` is [(leaf_i, tensor, index, shape)] for
        `store.write_process_shards`, with v (B, m', c), λ and the
        residuals (B, m') at rows [k·m'/S, (k+1)·m'/S) of slice rank k,
        and the sweeps and verdicts (B, S) at column k (the reference's
        per-slice-shard copies).  Ranks that differ only on the inner dim
        write the same ranges, whose bytes agree.  `host` is [(leaf_i,
        array)], the bookkeeping the master writes whole.  `meta` says
        carry_layout="device", so `_import` trims the padding and takes
        one column at restore; the step is then as mesh-independent as
        `_export`'s."""
        sched = self._plan.sched
        S, k = sched.slice_shards, sched.slice_index
        dev: List[Tuple] = []
        hst: List[Tuple[int, np.ndarray]] = []
        buckets_meta = []
        i = 0
        for bucket in sorted(self._tables):
            tb = self._tables[bucket]
            for carry in tb.state.carries:
                B, b, c = carry.v.shape
                rows = (k * b, (k + 1) * b)
                col = (k, k + 1)
                for leaf, index, shape in (
                        (carry.v, ((0, B), rows, (0, c)), (B, S * b, c)),
                        (carry.lam, ((0, B), rows), (B, S * b)),
                        (carry.resid, ((0, B), rows), (B, S * b)),
                        (carry.iters.reshape(B, 1), ((0, B), col), (B, S)),
                        (carry.done.reshape(B, 1), ((0, B), col), (B, S))):
                    dev.append((i, leaf, index, shape))
                    i += 1
            for leaf in self._export_sched_leaves(tb):
                hst.append((i, leaf))
                i += 1
            buckets_meta.append(self._bucket_meta(tb))
        return dev, hst, self._export_meta(buckets_meta,
                                           carry_layout="device")

    @classmethod
    def restore(cls, directory: str, *, mesh=None, device="cuda",
                step: Optional[int] = None, verify: bool = True,
                fault_injector=None, checkpoint_dir: Optional[str] = None,
                **policy_overrides) -> "MSCContinuousEngine":
        """Rebuild an engine from the newest restorable checkpoint under
        `directory` (the port's or the reference's, format 1) and resume
        mid-solve, on one device (`device`) or on `mesh`, whatever mesh
        wrote it: the carries are re-padded and each rank takes its rows;
        the blocks are rebuilt from the stashed tensors.  A step whose
        leaves fail their SHA check is skipped with a warning.  Keyword
        overrides replace checkpointed policy knobs (slots and cfg come
        from the checkpoint)."""
        steps = ([int(step)] if step is not None
                 else restorable_steps(directory, verify_sha=False))
        leaves = meta = None
        for s in steps:
            try:
                leaves, meta = load_leaves(directory, s, verify=verify)
                break
            except (IOError, OSError, ValueError) as e:
                warnings.warn(f"checkpoint step {s} failed restore ({e}); "
                              f"trying the previous step")
        if meta is None:
            raise FileNotFoundError(
                f"no restorable engine checkpoint under {directory!r}")
        policy = dict(meta["policy"])
        policy.update(policy_overrides)
        eng = cls(MSCConfig(**meta["cfg"]), slots=int(meta["slots"]),
                  dtype=getattr(torch, meta["dtype"]), device=device,
                  mesh=mesh, checkpoint_dir=checkpoint_dir or directory,
                  fault_injector=fault_injector, **policy)
        eng._import(leaves, meta)
        return eng

    def _import(self, leaves: List[np.ndarray], meta: Dict) -> None:
        """Rebuild every slot table from an `_export` leaf list, on this
        engine's device or mesh.  The counters come first: a bucket's
        autotune resolution (a cache hit, or a search) counts on top.
        A format-2 step (`_export_split`, either package's) holds the
        carries in the padded device layout: each mode's slice dim is
        trimmed to the bucket's size and the per-shard sweeps and
        verdicts give their first column, after which the import is
        format 1's."""
        self._stats = ServeStats(**meta["stats"])
        device_layout = meta.get("carry_layout") == "device"
        it = iter(leaves)
        np_dtype = _np_dtype(self.dtype)
        for bmeta in meta["buckets"]:
            bucket = tuple(int(x) for x in bmeta["bucket"])
            host_carries = []
            for j in range(3):
                v, lam, resid, iters, done = (next(it) for _ in range(5))
                if device_layout:
                    m = bucket[MODE_PERMS[j][0]]
                    v, lam, resid = v[:, :m], lam[:, :m], resid[:, :m]
                    iters, done = iters[:, 0], done[:, 0]
                host_carries.append(SolveState(v=v, lam=lam, resid=resid,
                                               iters=iters, done=done))
            dims = np.asarray(next(it), np.int32)
            fin = np.asarray(next(it), bool)
            slot_rids = np.asarray(next(it), np.int64)
            prio = np.asarray(next(it), np.int64).astype(np.int32)
            deadline = np.asarray(next(it), np.int64)
            progress = np.asarray(next(it), np.int64)
            queue = np.asarray(next(it), np.int64).reshape(-1, 4)
            arrs: List[Optional[torch.Tensor]] = [None] * self.slots
            for s in bmeta["live_slots"]:
                arrs[s] = torch.from_numpy(np.asarray(next(it), np_dtype))
            tb = self._table(bucket)
            tb.state.load(
                self._plan.rebuild_blocks(bucket, self.slots, self.dtype,
                                          arrs),
                self._plan.import_carries(bucket, host_carries))
            tb.slot_req = [None if r < 0 else int(r) for r in slot_rids]
            tb.arrs = arrs
            tb.dims = dims
            tb.fin = fin
            tb.chunk = int(bmeta["chunk"])
            tb.prio = prio
            tb.deadline = deadline
            tb.progress = progress
            parked_meta = {int(pm["rid"]): pm
                           for pm in bmeta.get("parked", [])}
            parked_arrs: Dict[int, torch.Tensor] = {}
            for pr, rid, submitted, dl in queue:
                tb.queue_for(int(pr)).append(
                    (int(rid), int(submitted), int(dl)))
                a = torch.from_numpy(np.asarray(next(it), np_dtype))
                if int(rid) in parked_meta:
                    parked_arrs[int(rid)] = a
                else:
                    self._pending[int(rid)] = a
            for pr, rid, _, dl in queue:
                pm = parked_meta.get(int(rid))
                if pm is None:
                    continue
                carr = []
                for j in range(3):
                    v, lam, resid = (np.asarray(next(it)) for _ in range(3))
                    carr.append(SolveState(
                        v=v, lam=lam, resid=resid,
                        iters=int(pm["iters"][j]),
                        done=bool(pm["done"][j])))
                tb.parked[int(rid)] = {
                    "arr": parked_arrs[int(rid)], "carries": carr,
                    "priority": int(pr), "deadline": int(dl),
                    "warm_meta": (None if pm["warm_meta"] is None
                                  else tuple(pm["warm_meta"])),
                    "progress": int(pm["progress"]),
                }
        self._next_rid = int(meta["next_rid"])
        self._total_chunks = int(meta["total_chunks"])
        self._tick = int(meta.get("tick", 0))
        self._chunks_since_ckpt = 0
        self._bump(restores=1)
