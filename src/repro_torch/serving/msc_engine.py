"""Batched multi-tensor MSC serving on one device.

Counterpart of the static engine in `repro/serving/msc_engine.py`.  Many
independent MSC requests share one dispatch per microbatch:

  * shape buckets — request dims round up to multiples of
    `bucket_quantum`, so nearby shapes share one padded shape.  Padding
    rides ModeSchedule's validity masks: per-request slice counts mask
    the padded slices and per-request column counts mask the start
    vectors, so a padded request solves the same problem as the
    unpadded one.
  * no executable cache — the reference compiles one executable per
    (bucket, microbatch size, dtype, mesh, config).  PyTorch runs
    eagerly: the engine builds one runner (`build_msc_batched`) and
    every bucket goes through it.  For parity of the stats, `compiles`
    counts the first dispatch of each bucket (where the reference
    compiles) and `exec_cache_hits` every later one; this is
    bookkeeping, not a measurement.
  * microbatch assembly — requests of a bucket are packed on the
    engine's device into microbatches of exactly `max_batch` slots,
    short ones filled with (1, 1, 1) zero requests that converge at the
    first gate probe and never hold the batch back.

Results come back per request on the host (CPU tensors), trimmed to the
true sizes, with each request's own `power_iters_run`.  The continuous
engine of the reference (slot tables, eviction, refill) is not ported.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.parallel import build_msc_batched
from repro_torch.core.types import (ModeResult, MSCConfig, MSCResult,
                                    resolve_device)

# filler requests need >= 1 valid slice and column per mode: an all-zero
# (1, 1, 1) request has zero residual (its gate fires at the first probe)
# and a nonempty masked start vector (no 0/0)
_FILLER_DIMS = (1, 1, 1)


@dataclasses.dataclass(frozen=True)
class ServeStats:
    """Counters of the serving hot path (cumulative per engine), with the
    reference's fields.  The static engine fills `requests`,
    `dispatches`, `compiles` (first dispatches of a bucket),
    `exec_cache_hits` (later ones) and `filler_slots`; the rest belong to
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


class MSCServeEngine:
    """Batched MSC serving on one device.

    cfg: MSCConfig shared by every request.
    max_batch: microbatch size B; every dispatch carries exactly B slots.
    bucket_quantum: dims round up to multiples of this.
    dtype: request tensor dtype at the engine boundary (the precision
      policy stays cfg.precision).
    device: where requests are packed and solved (`cuda` by default;
      `cpu` runs the kernels' plain versions).
    relayout: one of core.parallel.RELAYOUTS (all one local transpose on
      one device); "auto" is not ported.

    `run(tensors)` is the whole API: third-order tensors (torch or numpy)
    in, per-request host-side MSCResults at their true sizes out, in
    order.
    """

    def __init__(self, cfg: MSCConfig, *, max_batch: int = 8,
                 bucket_quantum: int = 8, dtype=torch.float32,
                 device="cuda", relayout: str = "gspmd"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._quantum = _bucket_quantum(bucket_quantum)
        self._run_batch = build_msc_batched(cfg, device=self.device,
                                            relayout=relayout)
        self._seen: Set[Tuple[int, int, int]] = set()
        self._stats = ServeStats()

    def bucket_of(self, shape: Sequence[int]) -> Tuple[int, int, int]:
        """Bucket = each dim rounded up to the engine quantum."""
        return _bucket_of(shape, self._quantum)

    @property
    def stats(self) -> ServeStats:
        return self._stats

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
        b = self.max_batch
        batch = torch.zeros((b,) + bucket, dtype=self.dtype,
                            device=self.device)
        dims = np.tile(np.int32(_FILLER_DIMS), (b, 1))
        for s, i in enumerate(chunk):
            t = tensors[i]
            if not isinstance(t, torch.Tensor):
                t = torch.from_numpy(np.array(t))
            m1, m2, m3 = t.shape
            batch[s, :m1, :m2, :m3] = t.to(self.device, self.dtype)
            dims[s] = t.shape
        out = self._run_batch(batch, dims)
        del batch
        first = bucket not in self._seen
        self._seen.add(bucket)
        self._stats = dataclasses.replace(
            self._stats,
            compiles=self._stats.compiles + first,
            exec_cache_hits=self._stats.exec_cache_hits + (not first),
            requests=self._stats.requests + len(chunk),
            dispatches=self._stats.dispatches + 1,
            filler_slots=self._stats.filler_slots + b - len(chunk))
        host = MSCResult(modes=tuple(
            dataclasses.replace(mr, mask=mr.mask.cpu(), d=mr.d.cpu(),
                                lambdas=mr.lambdas.cpu())
            for mr in out.modes))
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
