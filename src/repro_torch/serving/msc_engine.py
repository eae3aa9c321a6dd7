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
"""
from __future__ import annotations

import dataclasses
import functools
import math
from collections import defaultdict, deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.parallel import (C_OF, MSCChunkPlan, _collective_blocks,
                                       _flat_schedule, _mesh_device,
                                       batch_perm, check_relayout,
                                       collective_pads)
from repro_torch.core.power_iter import (SolveState, _gated_loop,
                                         compute_dtype, init_solve_state)
from repro_torch.core.schedule import TIERS_TODO, ModeSchedule, pad_to
from repro_torch.core.types import ModeResult, MSCConfig, MSCResult
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
    queue held work).  The rest belong to the serving tiers of ROADMAP.md
    queue 1 item 10 (fault tolerance, result cache, autotuner, SLO
    scheduler; see `repro/serving/msc_engine.py:ServeStats`) and stay 0
    here."""

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
      one device); "auto" is not ported.
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
        check_relayout(relayout, cfg.epilogue)
        self.cfg = cfg
        self.mesh = mesh
        self.max_batch = int(max_batch)
        self.dtype = dtype
        self.relayout = relayout
        self.device = _mesh_device(mesh, device)
        self._sched = _flat_schedule(cfg, mesh)
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
            prog = self._programs[bucket] = _BucketProgram(
                self._sched, bucket, self.max_batch, self.dtype, self.device,
                self.relayout)
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

def _control(perm, take_new, new_done, dims, new_dims) -> np.ndarray:
    """The refill's host inputs as one (B, 9) int32 array: perm,
    take_new, new_done, dims (3), new_dims (3)."""
    return np.concatenate([np.stack([perm, take_new, new_done], axis=1),
                           dims, new_dims], axis=1).astype(np.int32)


class _SlotState:
    """The device side of one bucket's slot table, and its two programs.

    Holds the plan's blocks and carries; `ops[j]`, block j in the
    precision policy's dtype, which the chunk step reads (the block
    itself where the dtypes agree, else a copy the refill rewrites after
    every repack: a copy taken once would go stale at the first refill);
    the staging blocks admitted requests are written to; `ctl`, the
    refill's host inputs (`_control`), written as one copy before each
    refill; and `finished`, the step's per-slot verdicts.  Every tensor
    keeps its address for the table's life, so the programs, once built
    (`build`: captured as two CUDA graphs in one memory pool on a card,
    called eagerly on the CPU), run on it in place.
    """

    def __init__(self, plan: MSCChunkPlan, bucket, slots: int, dtype,
                 device: torch.device):
        self.plan = plan
        self.device = device
        self.blocks, self.carries = plan.init_state(bucket, slots, dtype)
        cdt = compute_dtype(plan.sched.cfg.precision)
        self.ops = tuple(b if b.dtype == cdt else b.to(cdt)
                         for b in self.blocks)
        self.stage = tuple(torch.zeros_like(b) for b in self.blocks)
        fill = np.tile(np.int32(_FILLER_DIMS), (slots, 1))
        # neutral inputs: the warm-up before a capture changes no state
        self.ctl = torch.from_numpy(_control(
            np.arange(slots), np.zeros(slots), np.ones(slots), fill,
            fill)).to(device)
        self.finished = torch.zeros(slots, dtype=torch.bool, device=device)
        self.pool = (torch.cuda.graph_pool_handle()
                     if device.type == "cuda" else None)
        self._step_prog = plan.build_step()
        self._refill_prog = plan.build_refill()
        self.programs: Optional[Tuple[Step, Step]] = None

    def _step(self) -> None:
        _, fin = self._step_prog(self.ops, self.carries)
        self.finished.copy_(fin)

    def _refill(self) -> MSCResult:
        ctl = self.ctl
        _, _, res = self._refill_prog(self.blocks, self.carries, ctl[:, 3:6],
                                      self.stage, ctl[:, 6:9], ctl[:, 1],
                                      ctl[:, 2], ctl[:, 0])
        for op, block in zip(self.ops, self.blocks):
            if op is not block:
                op.copy_(block)
        return res

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

    def admit_write(self, s: int, tensor: torch.Tensor) -> None:
        """Write this rank's block of one admitted request's three
        unfoldings, zero-padded, over staging row s (the whole unfoldings
        on one device)."""
        x = tensor.to(self.device, self.blocks[0].dtype)
        for j, st in enumerate(self.stage):
            st[s].copy_(self.plan.local_block(j, x, st.shape[1:]))

    def refill(self, perm, take_new, new_done, dims, new_dims) -> MSCResult:
        """One refill: the inputs in one copy, then the program.  The
        results (device tensors) are overwritten by the next refill."""
        self.ctl.copy_(torch.from_numpy(_control(perm, take_new, new_done,
                                                 dims, new_dims)))
        return self.programs[1]()

    def step(self) -> np.ndarray:
        """One chunk step; returns the finished flags, read on the host."""
        self.programs[0]()
        return self.finished.cpu().numpy().copy()

    @property
    def static_bytes(self) -> int:
        ts = {id(t): t for t in (*self.blocks, *self.ops, *self.stage,
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
    the admission queues per priority class, the last chunk's finished
    flags and the cross-bucket credit.  Only class 0 is used: priority
    classes belong to the SLO scheduler (ROADMAP.md queue 1 item 10).
    Pure bookkeeping; the policy lives in the engine."""

    def __init__(self, bucket, slots: int, state: Optional[_SlotState]):
        self.bucket = bucket
        self.state = state
        self.slot_req: List[Optional[int]] = [None] * slots
        self.dims = np.tile(np.int32(_FILLER_DIMS), (slots, 1))
        # per-class FIFO queues of (rid, submit_tick); class 0 most urgent
        self.queues: Dict[int, Deque[Tuple[int, int]]] = {}
        self.chunk = 0
        self.fin = np.zeros(slots, bool)  # the last chunk's finished flags
        self.credit = 0.0  # cross-bucket device-time credit

    def queue_for(self, priority: int) -> Deque[Tuple[int, int]]:
        return self.queues.setdefault(int(priority), deque())

    def queue_len(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def pop_best(self):
        """Pop the head of the most urgent nonempty class: (priority, rid,
        submit_tick), or None.  (The reference ages queued classes by
        their wait; with one class that is FIFO.)"""
        for pr in sorted(self.queues):
            if self.queues[pr]:
                return (pr,) + self.queues[pr].popleft()
        return None

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
    scheduler tick on one bucket: the refill program evicts the slots
    the last chunk finished (finalizing their results from the frozen
    iterates), repacks the live slots and admits queued requests into the
    freed ones; then the step program advances every slot's three modes
    by `chunks_per_step` gate chunks.  Two programs per bucket
    (`MSCChunkPlan`), captured on a card as two CUDA graphs in one graph
    pool: a warm bucket captures nothing, whatever the arrival, eviction
    and placement sequence.  A capture that fails raises.  On the CPU,
    which the caller asks for explicitly, the same programs run eagerly.
    On a mesh (`mesh=`, as `MSCServeEngine`'s) each rank holds its blocks
    of every slot's unfoldings and its rows of the carries, and makes the
    same admission, eviction and rotation decisions as every other rank:
    they read only the step's finished flags (from the all-reduced gate)
    and the refill's gathered results.

    The policy and its knobs are the reference's:
      refill_min_free: repack only once this many slots are free (clamped
        to `slots`), except that
      max_queue_chunks: a request queued this many ticks of the engine's
        clock forces a refill at the next free slot (the starvation
        bound);
      placement: "compact" moves live slots to the front (slot order =
        admission order), "stable" leaves them in place;
      chunks_per_step: gate chunks per step (an int; "auto" is the
        roofline's, ROADMAP.md queue 1 item 11).
    With more than one bucket holding work, each tick runs the one with
    the most queue-depth credit (the reference's default "weighted"
    rotation).  Results do not depend on arrival order, placement or
    refill batching: every computation keeps the leading slot dim.

    The serving tiers stay ROADMAP.md queue 1 item 10 and raise
    `NotImplementedError` when set: priorities and deadlines,
    preemption (the reference's default turns it on, but with one
    priority class it never fires), shedding (`slo_chunks`),
    `bucket_policy="all"`, the result cache and warm starts,
    checkpointing, fault injection and autotuning.  The slot state is
    updated in place, the counterpart of the reference's donated
    buffers, so there is no donation switch.

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
                 preempt: bool = False, slo_chunks: Optional[int] = None,
                 bucket_policy: str = "weighted", checkpoint_dir=None,
                 result_cache=None, warm_start: bool = False,
                 autotune: bool = False, fault_injector=None, mesh=None):
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
        tiers = {"preempt": preempt, "slo_chunks": slo_chunks is not None,
                 "bucket_policy='all'": bucket_policy == "all",
                 "checkpoint_dir": checkpoint_dir is not None,
                 "result_cache": result_cache is not None,
                 "warm_start": warm_start, "autotune": autotune,
                 "fault_injector": fault_injector is not None}
        asked = [name for name, on in tiers.items() if on]
        if asked:
            raise NotImplementedError(f"{', '.join(asked)}: {TIERS_TODO}")
        self.cfg = cfg
        self.mesh = mesh
        self.slots = int(slots)
        self.dtype = dtype
        # clamped to the table: a threshold no drain reaches would stall
        # admission (the starvation clock only runs while chunks run)
        self.refill_min_free = min(max(1, int(refill_min_free)), self.slots)
        self.max_queue_chunks = int(max_queue_chunks)
        self.placement = placement
        self._plan = MSCChunkPlan(cfg, chunks_per_step, device=device,
                                  mesh=mesh)
        self.device = self._plan.device
        self._quantum = _bucket_quantum(bucket_quantum, self._plan.sched)
        self._tables: Dict[Tuple[int, int, int], _SlotTable] = {}
        self._pending: Dict[int, torch.Tensor] = {}
        self._next_rid = 0
        self._tick = 0  # the engine's scheduler clock
        self._wait_hist: Deque[int] = deque(maxlen=512)  # rolling waits
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
        return sum(tb.state.graphs for tb in self._tables.values())

    def memory_reckoning(self) -> Tuple[int, int]:
        """(bytes of the slot tables' static buffers, bytes their captures
        added to the graph pools): a live engine holds no more device
        memory than the two together.  The static buffers are, per
        bucket, the blocks, the staging blocks and the operand copies
        (under bf16_fp32) of three unfoldings of B slots, and the
        carries; the pools hold the programs' temporaries, among them the
        refill's gather scratch (one block)."""
        return (sum(tb.state.static_bytes for tb in self._tables.values()),
                sum(tb.state.pool_bytes for tb in self._tables.values()))

    def close(self) -> None:
        """Release every slot table and its graphs; queued and in-flight
        requests are dropped."""
        for tb in self._tables.values():
            tb.state.release()
        self._tables.clear()
        self._pending.clear()

    def _bump(self, **deltas) -> None:
        self._stats = dataclasses.replace(
            self._stats, **{k: getattr(self._stats, k) + v
                            for k, v in deltas.items()})

    def _table(self, bucket) -> _SlotTable:
        tb = self._tables.get(bucket)
        if tb is None:
            tb = self._tables[bucket] = _SlotTable(
                bucket, self.slots, _SlotState(self._plan, bucket, self.slots,
                                               self.dtype, self.device))
        return tb

    def _executables(self, tb: _SlotTable) -> None:
        """The bucket's two programs, built on its first tick."""
        if tb.state.programs is None:
            self._bump(compiles=tb.state.build())
        else:
            self._bump(exec_cache_hits=1)

    # ---- the decode loop ---------------------------------------------
    def submit(self, tensor, *, priority: int = 0,
               deadline_chunks: Optional[int] = None) -> int:
        """Queue one request (a third-order torch tensor or array, read
        when admitted); returns its id, the key `step()` returns its
        result under.  Priority classes and deadlines belong to the SLO
        scheduler (ROADMAP.md queue 1 item 10)."""
        if priority < 0:
            raise ValueError(f"priority must be >= 0, got {priority}")
        if priority != 0 or deadline_chunks is not None:
            raise NotImplementedError(f"priority classes and deadlines: "
                                      f"{TIERS_TODO}")
        if not isinstance(tensor, torch.Tensor):
            tensor = torch.from_numpy(np.array(tensor))
        tb = self._table(self.bucket_of(tuple(tensor.shape)))
        rid = self._next_rid
        self._next_rid += 1
        self._pending[rid] = tensor
        tb.queue_for(priority).append((rid, self._tick))
        self._bump(requests=1)
        return rid

    def has_work(self) -> bool:
        return any(tb.has_work() for tb in self._tables.values())

    def step(self) -> Dict[int, MSCResult]:
        """One scheduler tick: on one bucket (the one with the most
        accumulated queue-depth credit when several hold work), admit as
        the policy permits, advance one step, evict finished slots.
        Returns the requests that finished this tick; the engine keeps
        no copy."""
        finished: Dict[int, MSCResult] = {}
        self._tick += 1
        ready = [tb for tb in self._tables.values() if tb.has_work()]
        if len(ready) > 1:
            # credit grows on every bucket with work, so a skipped
            # bucket's claim grows; ties break on the bucket
            for tb in ready:
                tb.credit += tb.live + tb.queue_len()
            chosen = max(ready, key=lambda t: (t.credit, t.bucket))
            chosen.credit = 0.0
            ready = [chosen]
        for tb in ready:
            finished.update(self._step_table(tb))
        return finished

    def run(self, tensors: Sequence) -> List[MSCResult]:
        """Serve a closed set of requests to completion, in order.  Do not
        interleave with an outside submit()/step() loop: results step()
        hands out while run() drains are collected here and dropped."""
        rids = [self.submit(t) for t in tensors]
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

    def _permutation(self, tb: _SlotTable) -> np.ndarray:
        """Slot permutation of the repack (new[s] = old[perm[s]])."""
        if self.placement == "compact":
            order = ([s for s, r in enumerate(tb.slot_req) if r is not None]
                     + tb.free)
            return np.asarray(order, np.int32)
        return np.arange(self.slots, dtype=np.int32)

    def _refill(self, tb: _SlotTable, evict: List[int]
                ) -> Dict[int, MSCResult]:
        """Finalize the `evict` slots, free them, permute and admit: one
        run of the refill program.  Returns the evicted requests'
        results."""
        old_dims = tb.dims.copy()
        evicted = [(s, tb.slot_req[s]) for s in evict]
        for s in evict:
            tb.slot_req[s] = None
        perm = self._permutation(tb)
        tb.slot_req = [tb.slot_req[p] for p in perm]
        tb.dims = tb.dims[perm]
        tb.fin = tb.fin[perm]
        new_dims = np.tile(np.int32(_FILLER_DIMS), (self.slots, 1))
        take_new = np.zeros(self.slots, bool)
        new_done = np.ones(self.slots, bool)
        waits: List[int] = []
        for s in tb.free:
            entry = tb.pop_best()
            if entry is None:
                break
            _, rid, submitted = entry
            t = self._pending.pop(rid)
            tb.state.admit_write(s, t)
            new_dims[s] = tuple(t.shape)
            take_new[s] = True
            new_done[s] = False
            tb.slot_req[s] = rid
            tb.dims[s] = tuple(t.shape)
            tb.fin[s] = False
            waits.append(self._tick - submitted)
        results = tb.state.refill(perm, take_new, new_done, old_dims,
                                  new_dims)
        self._wait_hist.extend(waits)
        self._bump(refills=1, dispatches=1, queue_wait_chunks=sum(waits),
                   evictions=len(evicted))
        if waits:
            vals = np.asarray(self._wait_hist, float)
            self._stats = dataclasses.replace(
                self._stats,
                queue_wait_p50_chunks=float(np.percentile(vals, 50)),
                queue_wait_p99_chunks=float(np.percentile(vals, 99)))
        if not evicted:
            return {}
        host = _to_host(results.modes)  # before the next refill reuses them
        return {rid: _trim_request(host, s, tuple(int(x) for x in old_dims[s]))
                for s, rid in evicted}

    def _step_table(self, tb: _SlotTable) -> Dict[int, MSCResult]:
        self._executables(tb)
        # evict what the last chunk finished and admit queued requests:
        # one refill covers both
        evict = [s for s in range(self.slots)
                 if tb.fin[s] and tb.slot_req[s] is not None]
        out: Dict[int, MSCResult] = {}
        if evict or self._should_admit(tb, len(tb.free) + len(evict)):
            out = self._refill(tb, evict)
        if tb.live > 0:
            live = tb.live
            # refill batching can leave slots free while the bucket's
            # queue holds work
            if tb.queue_len() > 0 and len(tb.free) > 0:
                self._bump(idle_bucket_ticks=1)
            tb.fin = tb.state.step()
            tb.chunk += 1
            self._bump(chunk_steps=1, dispatches=1, slot_chunks=self.slots,
                       busy_slot_chunks=live)
        return out
