"""Deterministic fault injection for the continuous MSC engine —
counterpart of `repro/serving/faults.py`.

The engine has two dispatch sites per bucket (the chunk step and the
refill) and the checkpoint write; `FaultInjector` counts them and fires
what a `FaultPlan` schedules:

  * a transient dispatch failure: `fail_chunks` / `fail_refills` raise
    `InjectedFault` at the named 0-based dispatch indices, before the
    dispatch runs.  Retries advance the count too, so a run of indices
    (`fail_all_from`) is a persistent failure that exhausts the retries
    and sends the bucket to the sequential fallback;
  * a hard crash: `kill_chunk` / `kill_after_chunk` / `kill_refill` /
    `kill_checkpoint` SIGKILL the process at a dispatch boundary, with
    no cleanup, as a preempted node dies;
  * a corrupt checkpoint leaf: `corrupt_checkpoint_leaf` flips bytes of
    a committed leaf and leaves its manifest SHA, so a restore must skip
    to the previous step (`corrupt_checkpoint_shard`: the same for a
    per-process shard of a format-2 step).

`LoadShedError` is the engine's refusal of a submit while a bucket
recovers (or under its SLO bound).  `DistKillPlan` is the worker-side
injection of the multi-host control plane (`launch/distributed.py`):
it SIGKILLs a worker at a named point, set by `MSC_DIST_KILL`.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import signal
from typing import Optional, Tuple


class InjectedFault(RuntimeError):
    """A planted transient dispatch failure (retried by the policy)."""


class LoadShedError(RuntimeError):
    """submit() refused: the engine is recovering from a dispatch failure,
    or the request would wait past the SLO bound; resubmit later."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Which dispatches fail, and how.  Indices are 0-based per-kind
    counts over the engine's life (chunk steps, refills and checkpoint
    writes counted apart)."""

    fail_chunks: Tuple[int, ...] = ()
    fail_refills: Tuple[int, ...] = ()
    kill_chunk: Optional[int] = None        # SIGKILL before chunk #k
    kill_after_chunk: Optional[int] = None  # SIGKILL after chunk #k
    kill_refill: Optional[int] = None       # SIGKILL before refill #k
    kill_checkpoint: Optional[int] = None   # SIGKILL before write #k

    def __post_init__(self):
        object.__setattr__(self, "fail_chunks", tuple(self.fail_chunks))
        object.__setattr__(self, "fail_refills", tuple(self.fail_refills))


def _sigkill() -> None:
    os.kill(os.getpid(), signal.SIGKILL)


class FaultInjector:
    """Counts the engine's dispatch sites and fires the planned faults:
    `MSCContinuousEngine(..., fault_injector=...)` calls `before(kind)`
    and `after(kind)` around every dispatch.  The same plan and stream
    give the same fault at the same point in every run."""

    KINDS = ("chunk", "refill", "checkpoint")

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.counts = {k: 0 for k in self.KINDS}

    def before(self, kind: str) -> None:
        """Before dispatch #counts[kind]: may kill or raise."""
        i = self.counts[kind]
        kill = {"chunk": self.plan.kill_chunk,
                "refill": self.plan.kill_refill,
                "checkpoint": self.plan.kill_checkpoint}[kind]
        if kill is not None and i == kill:
            _sigkill()
        fail = {"chunk": self.plan.fail_chunks,
                "refill": self.plan.fail_refills,
                "checkpoint": ()}[kind]
        self.counts[kind] = i + 1
        if i in fail:
            raise InjectedFault(f"injected {kind} dispatch failure #{i}")

    def after(self, kind: str) -> None:
        """After dispatch #counts[kind] − 1 returned."""
        if kind == "chunk" and self.plan.kill_after_chunk is not None \
                and self.counts[kind] - 1 == self.plan.kill_after_chunk:
            _sigkill()


class DistKillPlan:
    """SIGKILL this process at the k-th occurrence of a named point of
    the multi-host control plane (`launch/distributed.py`).

    Points (0-based counts per point over the worker's life):
      "tick"  — on receiving tick #k, before the ready ack (the master
                sees the loss before any collective is entered);
      "step"  — after chunk step #k, before the done ack (mid-solve);
      "shard" — on checkpoint command #k, before any shard file is
                written (a torn step: it stays .tmp and is never
                selected by `restorable_steps`).

    `from_env` parses MSC_DIST_KILL="point:k" (None when unset), so a
    spawned worker needs no argument for it.
    """

    POINTS = ("tick", "step", "shard")

    def __init__(self, point: str, index: int):
        if point not in self.POINTS:
            raise ValueError(f"unknown kill point {point!r}; "
                             f"expected one of {self.POINTS}")
        self.point = point
        self.index = int(index)
        self._counts = {p: 0 for p in self.POINTS}

    @classmethod
    def from_env(cls, var: str = "MSC_DIST_KILL") -> Optional["DistKillPlan"]:
        val = os.environ.get(var)
        if not val:
            return None
        point, _, idx = val.partition(":")
        return cls(point, int(idx or 0))

    def hit(self, point: str) -> None:
        """Count one occurrence of `point`; kill if it is the planned one.
        No cleanup runs, as on a preempted host."""
        i = self._counts[point]
        self._counts[point] = i + 1
        if point == self.point and i == self.index:
            _sigkill()


def _flip_bytes(path: str, offset: int, nbytes: int) -> str:
    size = os.path.getsize(path)
    offset = min(offset, max(0, size - nbytes))
    with open(path, "r+b") as f:
        f.seek(offset)
        data = f.read(nbytes)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in data))
    return path


def corrupt_checkpoint_shard(directory: str, step: int,
                             offset: int = 128, nbytes: int = 8) -> str:
    """Flip bytes of the first per-process shard file of a committed
    format-2 step, leaving the manifest: `restorable_steps(verify_sha=True)`
    must reject the step."""
    shards = sorted(glob.glob(os.path.join(
        directory, f"step_{step:08d}", "leaf_*_p*_s*.npy")))
    if not shards:
        raise FileNotFoundError(
            f"no shard files under step {step} of {directory!r}")
    return _flip_bytes(shards[0], offset, nbytes)


def corrupt_checkpoint_leaf(directory: str, step: int, leaf_i: int = 0,
                            offset: int = 128, nbytes: int = 8) -> str:
    """Flip `nbytes` bytes of one committed leaf file in place, past its
    .npy header, leaving the manifest: the leaf fails its SHA check."""
    return _flip_bytes(os.path.join(directory, f"step_{step:08d}",
                                    f"leaf_{leaf_i:05d}.npy"),
                       offset, nbytes)


def fail_all_from(start: int, horizon: int = 10_000) -> Tuple[int, ...]:
    """Dispatch indices of a persistent failure: every one from `start`
    on fails, retries included."""
    return tuple(range(start, start + horizon))
