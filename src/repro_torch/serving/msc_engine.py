"""Batched multi-tensor MSC serving on one device.

Counterpart of the static engine in `repro/serving/msc_engine.py`.  Many
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

A warm engine holds each bucket's static buffers and graph pool
(`memory_reckoning`); `close()` releases them.  Results come back per
request on the host (CPU tensors and Python ints), trimmed to the true
sizes, with each request's own `power_iters_run`.  The eager runner
`core.parallel.build_msc_batched` computes the same results and is what
the graphs are held against.  The continuous engine of the reference
(slot tables, eviction, refill) is not ported.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.parallel import C_OF, batch_perm, check_relayout
from repro_torch.core.power_iter import (SolveState, _gated_loop,
                                         init_solve_state)
from repro_torch.core.schedule import ModeSchedule
from repro_torch.core.types import (ModeResult, MSCConfig, MSCResult,
                                    resolve_device)
from repro_torch.serving.graphs import Step, warm_up

# filler requests need >= 1 valid slice and column per mode: an all-zero
# (1, 1, 1) request has zero residual (its gate fires at the first probe)
# and a nonempty masked start vector (no 0/0)
_FILLER_DIMS = (1, 1, 1)


@dataclasses.dataclass(frozen=True)
class ServeStats:
    """Counters of the serving hot path (cumulative per engine), with the
    reference's fields.  The static engine fills `requests`,
    `dispatches`, `compiles` (CUDA graphs captured; on the CPU, first
    dispatches of a bucket), `exec_cache_hits` (dispatches that only
    replayed) and `filler_slots`; the rest belong to
    the continuous engine, its fault tolerance, result cache, autotuner
    and scheduler (see `repro/serving/msc_engine.py:ServeStats`), are
    kept so that engine can fill them, and stay 0 here."""

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


def _bucket_quantum(bucket_quantum: int) -> int:
    """The reference rounds the quantum up to a multiple of the mesh's
    shard counts; one device has one shard, so the quantum stands."""
    if int(bucket_quantum) < 1:
        raise ValueError(f"bucket_quantum must be >= 1, got {bucket_quantum}")
    return int(bucket_quantum)


def _bucket_of(shape: Sequence[int], quantum: int) -> Tuple[int, int, int]:
    if len(shape) != 3 or any(s < 1 for s in shape):
        raise ValueError(f"MSC serves third-order tensors, got {shape}")
    return tuple(-(-int(s) // quantum) * quantum for s in shape)


class _BucketProgram:
    """The programs of one bucket: static buffers and, per mode, the
    head, gate-chunk and tail `Step`s, captured on the first `run()` in
    one graph memory pool.

    `batch` (B, M1, M2, M3) and `dims` (B, 3) are written in place per
    dispatch; `flat` holds modes 1 and 2's unfoldings in turn (mode 0's
    is the batch itself).  Everything else the steps use (operands, the
    solve carry, results) is allocated by the captures from the pool, at
    addresses every replay reuses.  The tail drops the mode's operands
    once captured, so the next mode's head may reuse their memory: the
    steps replay in the order they were captured.
    """

    def __init__(self, sched: ModeSchedule, bucket, batch: int, dtype,
                 device: torch.device):
        self.sched = sched
        self.device = device
        self.batch = torch.zeros((batch,) + tuple(bucket), dtype=dtype,
                                 device=device)
        self.dims = torch.ones((batch, 3), dtype=torch.int32, device=device)
        self.flat = torch.empty(self.batch.numel(), dtype=dtype,
                                device=device)
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
        """Drop the steps and what they hold (the steps' functions refer
        back to this object, so the graphs and their pool would otherwise
        wait for the garbage collector)."""
        self.steps = [None] * 3
        self.live = [{} for _ in range(3)]

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
        if j == 0:
            slices = self.batch
        else:
            src = self.batch.permute(batch_perm(j))
            slices = self.flat[:src.numel()].view(src.shape)
            slices.copy_(src)
        plan, valid = self.sched.plan_mode_batched(
            slices, self.dims[:, j], self.dims[:, C_OF[j]])
        self.live[j].update(plan=plan, valid=valid, gated=plan.gated,
                            n_iters=plan.n_iters,
                            state=init_solve_state(plan.v0))

    def _chunk(self, j: int) -> None:
        live = self.live[j]
        state = live["state"]
        new = live["plan"].step(state)
        for f in dataclasses.fields(SolveState):
            getattr(state, f.name).copy_(getattr(new, f.name))

    def _tail(self, j: int) -> ModeResult:
        live = self.live[j]
        state, valid = live["state"], live["valid"]
        d, lam = self.sched._similarity_tail(live.pop("plan").finish(state),
                                             state.v, valid)
        return self.sched.finalize_mode_batched(d, lam, state.iters[..., None],
                                                live.pop("valid"))

    def _steps(self, j: int) -> Tuple[Step, Step, Step]:
        if self.steps[j] is None:
            fns = [functools.partial(f, j)
                   for f in (self._head, self._chunk, self._tail)]
            warm_up(fns, self.device)
            self.steps[j] = tuple(Step(fn, self.device, self.pool)
                                  for fn in fns)
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
    """Batched MSC serving on one device.

    cfg: MSCConfig shared by every request.
    max_batch: microbatch size B; every dispatch carries exactly B slots.
    bucket_quantum: dims round up to multiples of this.
    dtype: request tensor dtype at the engine boundary (the precision
      policy stays cfg.precision).
    device: where requests are packed and solved (`cuda` by default,
      through CUDA graphs; `cpu` runs the same steps eagerly, with the
      kernels' plain versions).
    relayout: one of core.parallel.RELAYOUTS (all one local transpose on
      one device); "auto" is not ported.

    `run(tensors)` is the whole API: third-order tensors (torch or numpy)
    in, per-request host-side MSCResults at their true sizes out, in
    order.  `close()` releases the buckets' buffers and graphs.
    """

    def __init__(self, cfg: MSCConfig, *, max_batch: int = 8,
                 bucket_quantum: int = 8, dtype=torch.float32,
                 device="cuda", relayout: str = "gspmd"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        check_relayout(relayout, cfg.epilogue)
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._quantum = _bucket_quantum(bucket_quantum)
        self._sched = ModeSchedule(cfg)
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
                self._sched, bucket, self.max_batch, self.dtype, self.device)
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
        # the host reads of the dispatch, after its device work
        host = MSCResult(modes=tuple(
            ModeResult(mask=mr.mask.cpu(), d=mr.d.cpu(),
                       lambdas=mr.lambdas.cpu(), n_iters=mr.n_iters.tolist(),
                       power_iters_run=mr.power_iters_run.tolist())
            for mr in modes))
        for s, i in enumerate(chunk):
            results[i] = _trim_request(host, s, tuple(int(x)
                                                      for x in dims[s]))


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
