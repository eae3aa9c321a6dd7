"""Multi-host MSC serving over `torch.distributed` — counterpart of
`repro/launch/distributed.py`.

The paper's system is distributed-memory; this layer turns the
continuous engine into it: N processes, one rank and one device each,
run ONE flat (slice, inner) mesh whose programs (the engine's CUDA
graphs on the cards, with the collectives inside) span the processes,
while a master/worker control plane keeps every process running the
same program sequence in lockstep.

Architecture (master = rank 0):

  * control channel — a small length-prefixed TCP protocol (a JSON
    header, then raw .npy array payloads), the reference's framing byte
    for byte, from the master to every worker.  The master owns
    admission and queueing; each scheduler tick it broadcasts the
    admitted tensors, gathers ready acks, and only then does any process
    apply them and step, so the engines (deterministic replicas of
    `MSCContinuousEngine`) see the same submit/step sequence and stay in
    step without exchanging engine state.
  * lockstep collectives — every process builds the same programs (same
    mesh, same bucket stream) and enters them together.  Each rank is a
    process of its own, so what the engine's host policy reads (the
    gate's all-reduced verdicts, the refill's gathered results) is the
    same everywhere; `replicate_outputs=True` carries the reference's
    policy (no preemption, no warm-start capture).  After its step a
    process drains its device (`torch.cuda.synchronize`) before its done
    ack, so a host dying between ticks never leaves a collective in
    flight on a survivor.
  * two-phase multi-host checkpoints — on a checkpoint tick every
    process writes its own rows of the carries straight from its device
    (`checkpoint/store.py:write_process_shards`, phase 1) and acks; the
    master then writes the host bookkeeping and the manifest
    (`commit_sharded_checkpoint`, phase 2).  A host dying in between
    leaves a `.tmp` step that `restorable_steps` never selects.
  * host-loss recovery — worker acks double as heartbeats.  A SIGKILLed
    worker's socket closes, so the master sees EOF at the next gather
    (or a heartbeat timeout if the worker hangs) BEFORE it enters a
    collective that would wait on the dead peer.  The master then aborts
    the surviving workers, drops its engine's graphs without replaying
    them, rebuilds the engine from the last committed checkpoint on its
    OWN device (`launch/elastic.py:restore_after_host_loss`, no mesh),
    resubmits every in-flight request the checkpoint did not capture,
    and serves on.  Masks and `power_iters_run` equal the uninterrupted
    run's.  The old process group is never used again: no collective,
    no `destroy_process_group` (under NCCL either can wait forever on
    the dead peer); after a loss the driver flushes its outputs and
    leaves through `os._exit(0)`.

`num_processes=1` is the degenerate mode: no channel, no process group,
every call forwarded to the engine on one device, so results and
`ServeStats` are the bare engine's, byte for byte.

Two processes on the CPU (gloo; the master spawns the worker):

  PYTHONPATH=src python -m repro_torch.launch.distributed \\
      --num-processes 2 --spawn-workers --device cpu \\
      --requests 6 --sizes 8,12 --ckpt-dir /tmp/msc_ckpt --ckpt-every 4

or one process per terminal (or host), one card each:

  PYTHONPATH=src python -m repro_torch.launch.distributed \\
      --num-processes 2 --process-id 0 --coordinator host0:12655 \\
      --control host0:12656 --requests 6
  PYTHONPATH=src LOCAL_RANK=0 python -m repro_torch.launch.distributed \\
      --num-processes 2 --process-id 1 --coordinator host0:12655 \\
      --control host0:12656

A torch process drives one rank, so the reference's
`--devices-per-process` has no counterpart; `--device cuda|cpu` picks
NCCL on the cards or gloo on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import socket
import struct
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serving.faults import DistKillPlan

_LEN = struct.Struct(">Q")


# ---- torch.distributed bring-up ---------------------------------------

@dataclasses.dataclass
class DistributedSpec:
    """One process's coordinates in the multi-host run.

    coordinator is the process group's rendezvous address (a TCPStore
    that process 0 hosts); control_address is this layer's
    master→worker TCP channel.  heartbeat_timeout_s bounds how long the
    master waits for a worker's ack before declaring the host lost (EOF
    on the socket, the SIGKILL case, is seen at once)."""

    num_processes: int = 1
    process_id: int = 0
    coordinator: str = "localhost:12655"
    control_address: str = "localhost:12656"
    heartbeat_timeout_s: float = 60.0
    connect_timeout_s: float = 60.0

    @property
    def is_master(self) -> bool:
        return self.process_id == 0


def init_distributed(spec: DistributedSpec, device="cuda") -> torch.device:
    """Join this process to the process group at `spec.coordinator`, one
    rank per process and one device per rank (NCCL and cuda:{local rank}
    for "cuda", gloo for "cpu"), and return its device.  With one
    process nothing is joined: the device itself."""
    from repro_torch.core.types import resolve_device
    from repro_torch.launch.mesh import join

    dev_type = torch.device(device).type
    if spec.num_processes <= 1:
        return resolve_device(device)
    return join(dev_type, rank=spec.process_id,
                world_size=spec.num_processes, address=spec.coordinator)


# ---- control-channel framing ------------------------------------------

class ChannelClosed(ConnectionError):
    """The peer's socket hit EOF: on SIGKILL the kernel closes it at once,
    so this is the instant host-loss signal."""


class HostLossError(RuntimeError):
    """One or more worker processes were declared lost."""

    def __init__(self, lost: Sequence[int]):
        super().__init__(f"lost worker process(es) {sorted(lost)}")
        self.lost = sorted(lost)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 22))
        if not chunk:
            raise ChannelClosed(f"peer closed after {len(buf)}/{n} bytes")
        buf += chunk
    return bytes(buf)


def send_msg(sock: socket.socket, header: Dict,
             arrays: Sequence[np.ndarray] = ()) -> int:
    """One framed message: length + JSON header, then length + .npy per
    array.  Returns the bytes sent."""
    blobs = [json.dumps({**header, "n_arrays": len(arrays)}).encode()]
    for a in arrays:
        buf = io.BytesIO()
        np.save(buf, np.asarray(a))  # not ascontiguousarray: keeps 0-d
        blobs.append(buf.getvalue())
    payload = b"".join(_LEN.pack(len(b)) + b for b in blobs)
    sock.sendall(payload)
    return len(payload)


def recv_msg(sock: socket.socket) -> Tuple[Dict, List[np.ndarray]]:
    header = json.loads(_recv_exact(sock, _LEN.unpack(
        _recv_exact(sock, _LEN.size))[0]))
    arrays = []
    for _ in range(header.pop("n_arrays", 0)):
        blob = _recv_exact(sock, _LEN.unpack(
            _recv_exact(sock, _LEN.size))[0])
        arrays.append(np.load(io.BytesIO(blob), allow_pickle=False))
    return header, arrays


def _parse_addr(address: str) -> Tuple[str, int]:
    host, _, port = address.rpartition(":")
    return host or "localhost", int(port)


class MasterChannel:
    """Master side: accepts one connection per worker, broadcasts
    commands, gathers acks (the heartbeats) with loss detection."""

    def __init__(self, address: str, num_workers: int):
        host, port = _parse_addr(address)
        self._listener = socket.create_server((host, port))
        self.address = f"{host}:{self._listener.getsockname()[1]}"
        self.num_workers = num_workers
        self._socks: Dict[int, socket.socket] = {}
        self.lost: set = set()
        self.bytes_sent = 0

    def accept_workers(self, timeout_s: float) -> None:
        self._listener.settimeout(timeout_s)
        deadline = time.monotonic() + timeout_s
        while len(self._socks) < self.num_workers:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"only {len(self._socks)}/{self.num_workers} workers "
                    f"connected within {timeout_s}s")
            sock, _ = self._listener.accept()
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            hello, _ = recv_msg(sock)
            self._socks[int(hello["process_id"])] = sock

    @property
    def live(self) -> List[int]:
        return sorted(p for p in self._socks if p not in self.lost)

    def broadcast(self, header: Dict, arrays: Sequence[np.ndarray] = ()):
        for pid in self.live:
            try:
                self.bytes_sent += send_msg(self._socks[pid], header, arrays)
            except (ConnectionError, OSError):
                self.lost.add(pid)

    def gather(self, tag: str, timeout_s: float) -> Tuple[Dict[int, Dict],
                                                          List[int]]:
        """One ack per live worker.  Returns (acks by pid, the pids lost
        in this gather: EOF or heartbeat timeout)."""
        acks: Dict[int, Dict] = {}
        newly_lost: List[int] = []
        for pid in self.live:
            sock = self._socks[pid]
            sock.settimeout(timeout_s)
            try:
                header, _ = recv_msg(sock)
                if header.get("tag") != tag:
                    raise ChannelClosed(
                        f"worker {pid}: expected ack {tag!r}, got {header}")
                acks[pid] = header
            except (ChannelClosed, socket.timeout, ConnectionError,
                    OSError):
                self.lost.add(pid)
                newly_lost.append(pid)
        return acks, newly_lost

    def close(self) -> None:
        for sock in self._socks.values():
            try:
                sock.close()
            except OSError:
                pass
        self._listener.close()


class WorkerChannel:
    """Worker side: one connection to the master, a blocking recv loop."""

    def __init__(self, address: str, process_id: int,
                 connect_timeout_s: float):
        host, port = _parse_addr(address)
        deadline = time.monotonic() + connect_timeout_s
        while True:
            try:
                self._sock = socket.create_connection((host, port),
                                                      timeout=5.0)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_msg(self._sock, {"cmd": "hello", "process_id": process_id})

    def recv(self) -> Tuple[Dict, List[np.ndarray]]:
        return recv_msg(self._sock)

    def send(self, header: Dict) -> None:
        send_msg(self._sock, header)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# ---- the distributed serving driver -----------------------------------

def _wire_array(tensor, dtype: torch.dtype) -> np.ndarray:
    """A request on the host as the wire carries it: the engine's dtype,
    float32 for bfloat16 (which numpy lacks; the cast is exact)."""
    from repro_torch.core.fingerprint import host_array

    t = torch.as_tensor(tensor).detach().to(dtype)
    return host_array(t.float() if dtype == torch.bfloat16 else t)


class MSCDistributedServer:
    """Master/worker lockstep driver around `MSCContinuousEngine`.

    Construct AFTER `init_distributed(spec, device)`.  The master has
    `submit()` / `step()` / `serve()`; workers run `run_worker()` until
    shutdown.  With num_processes=1 there is no channel, and every call
    forwards to the engine on `device`.

    The master coordinates the checkpoints (the engine's own stay off in
    distributed mode): after the tick whose chunk count passed
    `ckpt_every_chunks` since the last one, every process writes its
    carry rows into the staging directory and the master commits (two
    phases, see checkpoint/store.py).  After a host loss
    `host_loss_occurred` is True and the process must leave through
    `os._exit` once its outputs are flushed (see the module docstring).

    The master times its control plane: `control` holds the ticks run
    in lockstep, the seconds spent broadcasting and gathering acks, and
    the bytes sent to the workers.
    """

    def __init__(self, spec: DistributedSpec, cfg, *,
                 mesh_shape: Optional[Tuple[int, ...]] = None,
                 checkpoint_dir: Optional[str] = None,
                 ckpt_every_chunks: int = 8, keep_checkpoints: int = 3,
                 kill_plan: Optional[DistKillPlan] = None,
                 device="cuda", **engine_kwargs):
        from repro_torch.core.types import resolve_device
        from repro_torch.launch.elastic import best_msc_shape
        from repro_torch.launch.mesh import (make_msc_mesh, mesh_device,
                                             msc_mesh_shape)
        from repro_torch.serving.msc_engine import MSCContinuousEngine

        self.spec = spec
        self.checkpoint_dir = checkpoint_dir
        self.ckpt_every_chunks = int(ckpt_every_chunks)
        self.keep_checkpoints = int(keep_checkpoints)
        self.host_loss_occurred = False
        self.lost_hosts: List[int] = []
        self.recovery_s: Optional[float] = None
        # the .tmp steps at the moment of loss (the restored engine may
        # later checkpoint under the same step id, clearing them)
        self.torn_steps_at_loss: List[int] = []
        self.restored_step: Optional[int] = None
        self._kill = kill_plan
        self._engine_kwargs = dict(engine_kwargs)
        self.control = {"ticks": 0, "broadcast_s": 0.0, "ack_s": 0.0,
                        "wire_bytes": 0}
        distributed = spec.num_processes > 1
        if distributed:
            import torch.distributed as dist

            if not dist.is_initialized() or \
                    dist.get_world_size() != spec.num_processes:
                raise RuntimeError(
                    f"the process group has "
                    f"{dist.get_world_size() if dist.is_initialized() else 0}"
                    f" ranks, spec says {spec.num_processes}: call "
                    f"init_distributed first")
            self.mesh = make_msc_mesh(
                "flat", mesh_shape or best_msc_shape(spec.num_processes))
            self.device = mesh_device(self.mesh)
        else:
            if mesh_shape is not None:
                msc_mesh_shape("flat", 1, mesh_shape)  # validates
            self.mesh = None
            self.device = resolve_device(device)
        self.engine = MSCContinuousEngine(
            cfg, device=self.device, mesh=self.mesh,
            # one process: the engine checkpoints itself (format 1);
            # distributed: the control plane owns the timing and the
            # format-2 two-phase write
            checkpoint_dir=None if distributed else checkpoint_dir,
            ckpt_every_chunks=ckpt_every_chunks,
            keep_checkpoints=keep_checkpoints,
            replicate_outputs=distributed, **engine_kwargs)
        self._chan = None
        if distributed:
            if spec.is_master:
                chan = MasterChannel(spec.control_address,
                                     spec.num_processes - 1)
                chan.accept_workers(spec.connect_timeout_s)
                self._chan = chan
            else:
                self._chan = WorkerChannel(spec.control_address,
                                           spec.process_id,
                                           spec.connect_timeout_s)
        # the master's request bookkeeping (srid = server request id)
        self._next_srid = 0
        self._admit_buf: List[Tuple[int, object]] = []
        self._inflight: Dict[int, object] = {}
        self._srid2rid: Dict[int, int] = {}
        self._rid2srid: Dict[int, int] = {}
        self._tick = 0

    # ---- master API ---------------------------------------------------
    @property
    def stats(self):
        return self.engine.stats

    def submit(self, tensor) -> int:
        """Master only: queue one request for the next tick's broadcast.
        Returns the server request id its result comes back under.  With
        one process the tensor goes to the engine as it is; across
        processes every process (the master too) admits the bytes the
        wire carries."""
        if self._chan is not None:
            tensor = _wire_array(tensor, self.engine.dtype)
        srid = self._next_srid
        self._next_srid += 1
        self._admit_buf.append((srid, tensor))
        self._inflight[srid] = tensor
        return srid

    def has_work(self) -> bool:
        return bool(self._admit_buf) or bool(self._inflight)

    def step(self) -> Dict[int, object]:
        """One lockstep scheduler tick; returns {srid: MSCResult} of the
        requests that finished.  Coordinates checkpoints and recovers
        from a host loss itself; the tick of a loss returns no results
        (they finish again after the restore)."""
        admits, self._admit_buf = self._admit_buf, []
        if self._chan is None or self.host_loss_occurred:
            return self._local_tick(admits)
        try:
            return self._distributed_tick(admits)
        except HostLossError as e:
            return self._recover(e, admits)

    def serve(self, tensors: Sequence, max_ticks: int = 100_000
              ) -> List[object]:
        """Master only: submit everything, drive ticks to completion."""
        srids = [self.submit(t) for t in tensors]
        got: Dict[int, object] = {}
        ticks = 0
        while any(s not in got for s in srids):
            got.update(self.step())
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(f"requests still unfinished after "
                                   f"{max_ticks} ticks")
        return [got[s] for s in srids]

    def shutdown(self) -> None:
        """Master: release the workers (normal completion)."""
        if self._chan is not None and self.spec.is_master \
                and not self.host_loss_occurred:
            self._chan.broadcast({"cmd": "shutdown"})
            self._chan.gather("bye", self.spec.heartbeat_timeout_s)
        if self._chan is not None:
            self._chan.close()

    # ---- tick internals -----------------------------------------------
    def _apply_admissions(self, arrs: Sequence) -> List[int]:
        """The same on every process: same tensors in the same order give
        the same rids, queues and program sequence."""
        return [self.engine.submit(a) for a in arrs]

    def _deliver(self, finished: Dict[int, object]) -> Dict[int, object]:
        out = {}
        for rid, res in finished.items():
            srid = self._rid2srid.get(rid)
            if srid is None or srid not in self._inflight:
                continue  # finished again after a restore
            out[srid] = res
            del self._inflight[srid]
        return out

    def _map_rids(self, srids_arrs, rids) -> None:
        for (srid, _), rid in zip(srids_arrs, rids):
            self._srid2rid[srid] = rid
            self._rid2srid[rid] = srid

    def _local_tick(self, admits) -> Dict[int, object]:
        rids = self._apply_admissions([a for _, a in admits])
        self._map_rids(admits, rids)
        fin = self.engine.step() if self.engine.has_work() else {}
        self._tick += 1
        return self._deliver(fin)

    def _quiesce(self) -> None:
        """Drain this process's device queue, so a done ack certifies that
        no collective of this tick is still in flight (a host dying
        between ticks then never tears one on a survivor).  Nothing to
        drain on the CPU: gloo's collectives return complete."""
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)

    def _timed_gather(self, tag: str) -> Dict[int, Dict]:
        t0 = time.perf_counter()
        try:
            return self._gather_or_lose(tag)
        finally:
            self.control["ack_s"] += time.perf_counter() - t0

    def _distributed_tick(self, admits) -> Dict[int, object]:
        spec, chan, eng = self.spec, self._chan, self.engine
        self._tick += 1
        self.control["ticks"] += 1
        t0 = time.perf_counter()
        sent = chan.bytes_sent
        chan.broadcast({"cmd": "tick", "tick": self._tick},
                       [a for _, a in admits])
        self.control["broadcast_s"] += time.perf_counter() - t0
        self.control["wire_bytes"] += chan.bytes_sent - sent
        self._timed_gather("ready")
        rids = self._apply_admissions([a for _, a in admits])
        self._map_rids(admits, rids)
        try:
            if eng.has_work():
                fin = eng.step()
                self._quiesce()
            else:
                fin = {}
        except Exception:
            # a collective failed under us (gloo reports a dead peer as
            # an error): the sockets say who
            _, newly = chan.gather("done", 1.0)
            raise HostLossError(newly or chan.lost or
                                list(range(1, spec.num_processes)))
        self._timed_gather("done")
        if (self.checkpoint_dir is not None and self.ckpt_every_chunks > 0
                and eng._chunks_since_ckpt >= self.ckpt_every_chunks):
            self._coordinated_checkpoint()
        return self._deliver(fin)

    def _gather_or_lose(self, tag: str) -> Dict[int, Dict]:
        acks, newly_lost = self._chan.gather(
            tag, self.spec.heartbeat_timeout_s)
        if newly_lost:
            self.engine.note_ft_event(heartbeats_missed=len(newly_lost))
            raise HostLossError(newly_lost)
        return acks

    # ---- two-phase multi-host checkpoint ------------------------------
    def _coordinated_checkpoint(self) -> None:
        from repro_torch.checkpoint.store import (begin_sharded_checkpoint,
                                                  commit_sharded_checkpoint,
                                                  gc_checkpoints,
                                                  write_process_shards)

        eng = self.engine
        step_id = eng._total_chunks
        tmp = begin_sharded_checkpoint(self.checkpoint_dir, step_id)
        self._chan.broadcast({"cmd": "ckpt", "step": step_id,
                              "dir": self.checkpoint_dir})
        device, host, meta = eng._export_split()
        n_files = write_process_shards(tmp, self.spec.process_id, device)
        acks = self._timed_gather("shard")
        n_files += sum(int(a.get("files", 0)) for a in acks.values())
        commit_sharded_checkpoint(
            self.checkpoint_dir, step_id,
            num_processes=self.spec.num_processes, full_leaves=host,
            extra=meta)
        gc_checkpoints(self.checkpoint_dir, self.keep_checkpoints)
        eng._chunks_since_ckpt = 0
        eng.note_ft_event(checkpoints_written=1,
                          shard_files_written=n_files)

    # ---- host-loss recovery -------------------------------------------
    def _recover(self, loss: HostLossError, admits) -> Dict[int, object]:
        """Rebuild on this process's own device with no mesh, resume from
        the last committed checkpoint, resubmit what it did not capture.
        The old process group is never touched again; later ticks run
        through _local_tick."""
        import warnings

        from repro_torch.checkpoint.store import latest_restorable
        from repro_torch.launch.elastic import restore_after_host_loss
        from repro_torch.serving.msc_engine import MSCContinuousEngine

        t0 = time.monotonic()
        self.host_loss_occurred = True
        self.lost_hosts = sorted(set(self.lost_hosts) | set(loss.lost))
        self._chan.broadcast({"cmd": "abort"})  # best effort to survivors
        self._chan.close()
        old = self.engine
        old_stats = old.stats
        # drop the old tables and graphs unreplayed (their collectives
        # name the dead peer)
        old.close()
        restored = None
        # slots and dtype are structural: restore() takes them from the
        # checkpoint, so only the other engine knobs are forwarded
        knobs = {k: v for k, v in self._engine_kwargs.items()
                 if k not in ("slots", "dtype")}
        if self.checkpoint_dir is not None and \
                os.path.isdir(self.checkpoint_dir):
            self.torn_steps_at_loss = sorted(
                int(n[len("step_"):-len(".tmp")])
                for n in os.listdir(self.checkpoint_dir)
                if n.startswith("step_") and n.endswith(".tmp")
                and n[len("step_"):-len(".tmp")].isdigit())
            self.restored_step = latest_restorable(self.checkpoint_dir,
                                                   verify_sha=False)
        if self.restored_step is not None:
            restored = restore_after_host_loss(
                self.checkpoint_dir, device=self.device,
                checkpoint_dir=self.checkpoint_dir,
                ckpt_every_chunks=self.ckpt_every_chunks,
                keep_checkpoints=self.keep_checkpoints, **knobs)
        if restored is None:
            warnings.warn("host loss with no committed checkpoint: "
                          "rebuilding a fresh engine and resubmitting "
                          "everything")
            restored = MSCContinuousEngine(
                old.cfg, device=self.device,
                checkpoint_dir=self.checkpoint_dir,
                ckpt_every_chunks=self.ckpt_every_chunks,
                keep_checkpoints=self.keep_checkpoints,
                **self._engine_kwargs)
        self.engine = restored
        self.mesh = None
        # the fault-tolerance counters survive the swap (the restored
        # engine's predate the loss)
        rs = restored.stats
        restored.note_ft_event(
            heartbeats_missed=old_stats.heartbeats_missed
            - rs.heartbeats_missed,
            host_losses=old_stats.host_losses + len(loss.lost)
            - rs.host_losses,
            reinits=old_stats.reinits + 1 - rs.reinits,
            shard_files_written=old_stats.shard_files_written
            - rs.shard_files_written)
        # a rid lives on in the restored engine iff the checkpoint held
        # it in flight; everything else (this tick's admissions too) is
        # resubmitted under a new rid.  Results delivered before stay
        # delivered; their second finish is dropped by _deliver.
        known = set(restored._pending)
        for tb in restored._tables.values():
            known.update(r for r in tb.slot_req if r is not None)
        for srid, arr in list(self._inflight.items()):
            rid = self._srid2rid.get(srid)
            if rid is not None and rid in known:
                continue  # the checkpoint carries it mid-solve
            if rid is not None:
                self._rid2srid.pop(rid, None)
            new_rid = restored.submit(arr)
            self._srid2rid[srid] = new_rid
            self._rid2srid[new_rid] = srid
        self.recovery_s = time.monotonic() - t0
        return {}

    # ---- worker loop --------------------------------------------------
    def run_worker(self) -> int:
        """Worker main loop: obey ticks until shutdown or abort.  Returns
        a process exit code; after an abort (the master saw a host loss)
        or the master's death the caller must leave through os._exit,
        with no teardown of the process group."""
        from repro_torch.checkpoint.store import write_process_shards

        chan, eng, kill = self._chan, self.engine, self._kill
        while True:
            try:
                header, arrays = chan.recv()
            except ChannelClosed:
                return 3  # the master died: nothing left to do
            cmd = header.get("cmd")
            if cmd == "shutdown":
                chan.send({"tag": "bye"})
                chan.close()
                return 0
            if cmd == "abort":
                chan.close()
                return 4
            if cmd == "tick":
                if kill is not None:
                    kill.hit("tick")
                chan.send({"tag": "ready"})
                self._apply_admissions(arrays)
                if eng.has_work():
                    eng.step()
                    self._quiesce()
                if kill is not None:
                    kill.hit("step")
                chan.send({"tag": "done"})
            elif cmd == "ckpt":
                if kill is not None:
                    kill.hit("shard")
                tmp = os.path.join(header["dir"],
                                   f"step_{int(header['step']):08d}.tmp")
                device, _, _ = eng._export_split()
                n = write_process_shards(tmp, self.spec.process_id, device)
                eng._chunks_since_ckpt = 0
                chan.send({"tag": "shard", "files": n})
            else:
                raise RuntimeError(f"unknown control command {header}")


# ---- CLI ----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_workers(args, coordinator: str, control: str):
    """Master convenience: start the worker processes on this host (the
    one-command multi-process run), rank r on cuda:r with --device
    cuda."""
    import subprocess

    procs = []
    for pid in range(1, args.num_processes):
        env = dict(os.environ)
        env.pop("MSC_DIST_KILL", None)
        if args.worker_kill_at:
            env["MSC_DIST_KILL"] = args.worker_kill_at
        cmd = [sys.executable, "-m", "repro_torch.launch.distributed",
               "--num-processes", str(args.num_processes),
               "--process-id", str(pid),
               "--coordinator", coordinator, "--control", control,
               "--slots", str(args.slots),
               "--ckpt-every", str(args.ckpt_every),
               "--device", args.device,
               "--power-tol", repr(args.power_tol),
               "--heartbeat-timeout", repr(args.heartbeat_timeout)]
        if args.power_iters:
            cmd += ["--power-iters", str(args.power_iters)]
        if args.check_every:
            cmd += ["--check-every", str(args.check_every)]
        if args.kernels:
            cmd.append("--kernels")
        if args.mesh_shape:
            cmd += ["--mesh-shape", args.mesh_shape]
        if args.ckpt_dir:
            cmd += ["--ckpt-dir", args.ckpt_dir]
        procs.append(subprocess.Popen(cmd, env=env))
    return procs


def _reap(workers) -> None:
    for p in workers:
        try:
            p.wait(timeout=30)
        except Exception:
            p.kill()
            p.wait()


def _mesh_items(server) -> List[List]:
    """The serving mesh's [dim, size] pairs; one device is the
    reference's (1, 1) mesh."""
    from repro_torch.launch.mesh import mesh_dims

    if server.mesh is None:
        return [["slice", 1], ["inner", 1]]
    return [[a, int(v)] for a, v in mesh_dims(server.mesh).items()]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Multi-host MSC serving over torch.distributed: one "
                    "rank and one device per process (so the reference's "
                    "--devices-per-process has no counterpart); the "
                    "master (process 0) owns admission and broadcasts "
                    "each tick's requests over a TCP control channel")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--coordinator", default=None,
                    help="process-group rendezvous host:port, a TCPStore "
                         "process 0 hosts (default: picked by the master "
                         "with --spawn-workers)")
    ap.add_argument("--control", default=None,
                    help="master→worker control channel host:port")
    ap.add_argument("--spawn-workers", action="store_true",
                    help="the master starts the worker processes on this "
                         "host (one command)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: NCCL, process r on cuda:r (one card per "
                         "process); cpu: gloo")
    ap.add_argument("--worker-kill-at", default=None, metavar="POINT:K",
                    help="with --spawn-workers: set MSC_DIST_KILL in the "
                         "workers (tick:K | step:K | shard:K)")
    ap.add_argument("--mesh-shape", default=None,
                    help="(slice, inner) factorization, e.g. '2,1'")
    ap.add_argument("--sizes", default="8,12")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--slow-every", type=int, default=0)
    ap.add_argument("--gamma", type=float, default=None,
                    help="γ of the requests that are not --slow-every's "
                         "(default max(m, 40); the slow ones have γ = 2)")
    ap.add_argument("--submit-per-tick", type=int, default=0,
                    help="stagger submissions N per tick (0 = all "
                         "upfront)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=4)
    ap.add_argument("--power-tol", type=float, default=1e-2)
    ap.add_argument("--power-iters", type=int, default=0,
                    help="the sweep cap (0: the config's default)")
    ap.add_argument("--check-every", type=int, default=0,
                    help="sweeps per gate probe (0: the config's default)")
    ap.add_argument("--kernels", action="store_true",
                    help="the CUDA kernels (their plain versions on the "
                         "CPU)")
    ap.add_argument("--heartbeat-timeout", type=float, default=60.0,
                    help="seconds the master waits for a worker's ack")
    ap.add_argument("--outdir", default=None,
                    help="write results.npz + stats.json here")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    multi = args.num_processes > 1
    is_master = args.process_id == 0
    coordinator = args.coordinator or f"localhost:{_free_port()}"
    control = args.control or f"localhost:{_free_port()}"
    workers = []
    if multi and is_master and args.spawn_workers:
        workers = _spawn_workers(args, coordinator, control)

    spec = DistributedSpec(num_processes=args.num_processes,
                           process_id=args.process_id,
                           coordinator=coordinator,
                           control_address=control,
                           heartbeat_timeout_s=args.heartbeat_timeout)
    if args.device == "cpu":
        torch.set_num_threads(1)
    device = init_distributed(spec, args.device)

    from repro_torch.core import MSCConfig
    from repro_torch.launch.mesh import leave, parse_shape
    from repro_torch.launch.msc_serve import build_request_stream

    kw = {}
    if args.power_iters:
        kw["power_iters"] = args.power_iters
    if args.check_every:
        kw["power_check_every"] = args.check_every
    cfg = MSCConfig(epsilon=3e-4, power_tol=args.power_tol,
                    use_kernels=args.kernels, **kw)
    server = MSCDistributedServer(
        spec, cfg, mesh_shape=parse_shape(args.mesh_shape),
        checkpoint_dir=args.ckpt_dir, ckpt_every_chunks=args.ckpt_every,
        slots=args.slots, kill_plan=DistKillPlan.from_env(), device=device)

    if not is_master:
        rc = server.run_worker()
        if rc == 0:
            server.engine.close()  # its graphs hold the communicators
            leave()
            return 0
        sys.stdout.flush()
        sys.stderr.flush()
        # abort or the master's death: no teardown (it would wait on the
        # dead peer); see the module docstring
        os._exit(rc)

    sizes = [int(s) for s in args.sizes.split(",")]
    _, tensors = build_request_stream(sizes, args.requests, args.seed,
                                      slow_every=args.slow_every,
                                      device=device, gamma_fast=args.gamma)
    print(f"MSC distributed serve: {args.num_processes} process(es), "
          f"{args.num_processes} devices, mesh "
          f"{dict((a, v) for a, v in _mesh_items(server))}, "
          f"{args.requests} requests over sizes {sizes}", flush=True)

    t0 = time.time()
    got: Dict[int, object] = {}
    srids: List[int] = []
    nxt = 0
    per_tick = args.submit_per_tick or len(tensors)
    while nxt < len(tensors) or any(s not in got for s in srids):
        while nxt < len(tensors) and len(srids) - len(got) < per_tick:
            srids.append(server.submit(tensors[nxt]))
            nxt += 1
        got.update(server.step())
    serve_s = time.time() - t0
    results = [got[s] for s in srids]
    server.shutdown()

    for i in (0, len(results) - 1):
        sw = [int(results[i][j].power_iters_run) for j in range(3)]
        print(f"  req {i}: sweeps={sw}", flush=True)
    s = server.stats
    print(f"served {len(results)} requests in {serve_s:.2f}s "
          f"({len(results) / serve_s:.2f} req/s)", flush=True)
    print(f"  fault tolerance: {s.checkpoints_written} checkpoints, "
          f"{s.restores} restores, {s.heartbeats_missed} heartbeats "
          f"missed, {s.host_losses} host losses, {s.reinits} reinits, "
          f"{s.shard_files_written} shard files", flush=True)
    c = server.control
    if c["ticks"]:
        print(f"  control plane: {c['ticks']} lockstep ticks, broadcast "
              f"{c['broadcast_s'] * 1e3 / c['ticks']:.3f} ms and acks "
              f"{c['ack_s'] * 1e3 / c['ticks']:.3f} ms a tick, "
              f"{c['wire_bytes'] / c['ticks']:.0f} wire bytes a tick",
              flush=True)

    if args.outdir:
        from repro_torch.kernels import power_iter as kpi
        from repro_torch.kernels import ring as kring

        os.makedirs(args.outdir, exist_ok=True)
        payload = {}
        for i, res in enumerate(results):
            for j in range(3):
                payload[f"mask_{i}_{j}"] = np.asarray(res[j].mask)
                payload[f"d_{i}_{j}"] = np.asarray(res[j].d)
            payload[f"iters_{i}"] = np.asarray(
                [int(res[j].power_iters_run) for j in range(3)])
        np.savez(os.path.join(args.outdir, "results.npz"), **payload)
        with open(os.path.join(args.outdir, "stats.json"), "w") as f:
            json.dump({**dataclasses.asdict(s),
                       "serve_s": serve_s,
                       "n_results": len(results),
                       "lost_hosts": server.lost_hosts,
                       "recovery_s": server.recovery_s,
                       "torn_steps_at_loss": server.torn_steps_at_loss,
                       "restored_step": server.restored_step,
                       "mesh": _mesh_items(server),
                       "device": str(server.engine.device),
                       # the master's kernel launches (0 on the CPU)
                       "launches": {"power_iter": kpi.launches,
                                    "abs_rowsum": kring.launches},
                       "control": c}, f)

    if server.host_loss_occurred:
        _reap(workers)  # the abort was broadcast: no orphans
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)  # no teardown of the group (see the module docstring)
    server.engine.close()
    if multi:
        leave()
    _reap(workers)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
