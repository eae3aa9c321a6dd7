"""MSC meshes over `torch.distributed` — counterpart of `repro/launch/mesh.py`.

The reference's meshes hold the devices of one process; here a mesh is
one process per device (a rank), joined into a process group and laid
out as a `torch.distributed.device_mesh.DeviceMesh` with the reference's
dim names: ("slice",) or ("slice", "inner") for the flat schedule,
("mode", "slice"[, "inner"]) for the grouped one.  gloo joins ranks on
the CPU, NCCL on the card (rank r on cuda:{local rank}).

Ranks join in one of two ways (`join`):
  * under `torchrun`, from its environment (`env://`);
  * from a FileStore that every rank opens, when this package spawns its
    own ranks (`spawn`: `msc_run --nproc N` and the tests).

Nothing here runs at import: a mesh exists once `join` has run in every
rank.  The production (data, model) meshes and the LM serving meshes
are ROADMAP.md queue 1 item 9 (rest).
"""
from __future__ import annotations

import datetime
import math
import os
import time

import torch

DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


def msc_mesh_shape(schedule: str, n: int, shape=None):
    """(axis_names, dims) of an MSC mesh over n devices — validated.

    flat:    1-D ("slice",) by default; shape=(p, q) adds the "inner"
             axis (2-D within-slice sharding).
    grouped: ("mode", "slice") with mode=3 (paper Fig. 3); shape=(s, q)
             (mode=3 implied) or (3, s, q) adds "inner".

    Raises ValueError with the usable factorizations when the device
    count does not divide (the reference's messages, word for word).
    """
    shape = tuple(int(s) for s in shape) if shape is not None else None
    if schedule == "flat":
        if shape is None:
            shape = (n,)
        if len(shape) not in (1, 2):
            raise ValueError(
                f"flat schedule takes shape=(slice,) or (slice, inner), "
                f"got {shape}")
        if math.prod(shape) != n:
            hints = [(n, 1)] + ([(n // 2, 2)] if n % 2 == 0 else [])
            raise ValueError(
                f"mesh shape {shape} uses {math.prod(shape)} devices but "
                f"{n} are available; pick p*q == {n} "
                f"(e.g. {' or '.join(map(str, hints))})")
        axes = ("slice",) if len(shape) == 1 else ("slice", "inner")
        return axes, shape
    if schedule == "grouped":
        if shape is not None and len(shape) == 3:
            if shape[0] != 3:
                raise ValueError(
                    f"grouped schedule needs mode=3 groups (paper Fig. 3), "
                    f"got leading dim {shape[0]} in {shape}")
            shape = shape[1:]
        if n % 3:
            raise ValueError(
                f"grouped schedule needs 3 | device count, got p={n}; "
                f"nearest usable counts are {n - n % 3 or 3} and "
                f"{n + 3 - n % 3}")
        if shape is None:
            shape = (n // 3,)
        if len(shape) not in (1, 2):
            raise ValueError(
                f"grouped schedule takes shape=(slice,), (slice, inner) or "
                f"(3, slice, inner), got {shape}")
        if 3 * math.prod(shape) != n:
            raise ValueError(
                f"grouped mesh shape {shape} needs 3*{math.prod(shape)}="
                f"{3 * math.prod(shape)} devices but {n} are available; "
                f"pick slice*inner == {n // 3}")
        axes = ("mode", "slice") if len(shape) == 1 \
            else ("mode", "slice", "inner")
        return axes, (3,) + shape
    raise ValueError(f"unknown schedule {schedule!r}")


def parse_shape(text):
    """'4,2' → (4, 2); None stays None."""
    return tuple(int(s) for s in text.split(",")) if text else None


def launched_by_torchrun() -> bool:
    """True inside a process that `torchrun` started."""
    return "TORCHELASTIC_RUN_ID" in os.environ or (
        "RANK" in os.environ and "WORLD_SIZE" in os.environ)


def join(device_type: str = "cuda", *, rank=None, world_size=None,
         store_file=None, timeout=DEFAULT_TIMEOUT) -> torch.device:
    """Join this process to the default process group and return its
    device: gloo and `cpu` for device_type "cpu", NCCL and
    cuda:{local rank} for "cuda".

    With `store_file`, the ranks meet in a FileStore at that path
    (rank and world_size given); without it, in torchrun's environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT).  A
    collective that waits longer than `timeout` raises in every rank
    that waits.  More ranks on a node than its cards raises ValueError.
    """
    import torch.distributed as dist

    if store_file is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is False; pass "
                               "device 'cpu' to join over gloo")
        if local_world > torch.cuda.device_count():
            raise ValueError(
                f"{local_world} ranks on this node but "
                f"{torch.cuda.device_count()} CUDA devices; one rank per "
                f"card")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device_type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"no process group for device type {device_type!r}")
    kw = dict(backend=backend, timeout=timeout)
    if device_type == "cuda":
        kw["device_id"] = device
    if store_file is None:
        dist.init_process_group(init_method="env://", **kw)
    else:
        store = dist.FileStore(str(store_file), world_size)
        dist.init_process_group(store=store, rank=rank,
                                world_size=world_size, **kw)
    return device


def leave() -> None:
    """Tear down the default process group (and with it every mesh's
    groups), if there is one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def make_msc_mesh(schedule: str = "flat", shape=None, device_type=None):
    """DeviceMesh over every rank of the default process group.  flat:
    ("slice",) or ("slice", "inner"); grouped: ("mode", "slice"[,
    "inner"]) with mode=3.  shape= overrides the default 1-D
    factorization — (p, q) for flat, (s, q) or (3, s, q) for grouped —
    and is validated against the world size.  device_type defaults to
    the process group's ("cuda" under NCCL, else "cpu")."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    axes, dims = msc_mesh_shape(schedule, dist.get_world_size(), shape)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(dims), mesh_dim_names=axes)


def mesh_dims(mesh) -> dict:
    """{dim name: size}, the reference's `dict(mesh.shape)`."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def chips(mesh) -> int:
    return mesh.size()


def mesh_device(mesh) -> torch.device:
    """This rank's device on the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _rank_main(rank, fn, world_size, store_file, device_type, timeout,
               args):
    """One spawned rank: join, run fn(device, *args), leave.  An
    exception ends the process with a nonzero code (and its traceback)."""
    if device_type == "cpu":
        torch.set_num_threads(1)
    device = join(device_type, rank=rank, world_size=world_size,
                  store_file=store_file, timeout=timeout)
    try:
        fn(device, *args)
    finally:
        leave()


def spawn(fn, nproc: int, store_file, *args, device_type: str = "cuda",
          timeout=DEFAULT_TIMEOUT, join_timeout=None) -> None:
    """Run fn(device, *args) in `nproc` new processes, one rank each,
    joined through a FileStore at `store_file` (a path no other run
    uses): NCCL ranks on the cards by default, gloo ranks on the CPU
    with device_type "cpu".  fn must be importable by name (the
    processes start fresh).

    Waits for every rank; a rank that fails, or the whole run not ending
    within `join_timeout` seconds, kills the others and raises
    RuntimeError.  On the CPU each rank runs one thread.
    """
    import torch.multiprocessing as tmp

    if nproc < 1:
        raise ValueError(f"nproc must be >= 1, got {nproc}")
    if device_type == "cuda" and nproc > torch.cuda.device_count():
        raise ValueError(f"{nproc} ranks asked but "
                         f"{torch.cuda.device_count()} CUDA devices; one "
                         f"rank per card")
    ctx = tmp.start_processes(
        _rank_main, args=(fn, nproc, str(store_file), device_type, timeout,
                          args),
        nprocs=nproc, join=False, start_method="spawn")
    deadline = None if join_timeout is None else (time.monotonic()
                                                  + join_timeout)
    try:
        while not ctx.join(None if deadline is None else
                           max(0.0, deadline - time.monotonic())):
            if deadline is not None and time.monotonic() >= deadline:
                alive = sum(p.is_alive() for p in ctx.processes)
                raise RuntimeError(f"{alive} of {nproc} ranks still running "
                                   f"after {join_timeout} s")
    except (tmp.ProcessRaisedException,
            tmp.ProcessExitedException) as e:
        raise RuntimeError(f"rank {e.error_index} of {nproc} failed: "
                           f"{e}") from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
