"""MSC meshes over `torch.distributed` — counterpart of `repro/launch/mesh.py`.

The reference's meshes hold the devices of one process; here a mesh is
one process per device (a rank), joined into a process group and laid
out as a `torch.distributed.device_mesh.DeviceMesh` with the reference's
dim names: ("slice",) or ("slice", "inner") for the flat schedule,
("mode", "slice"[, "inner"]) for the grouped one.  gloo joins ranks on
the CPU, NCCL on the card (rank r on cuda:{local rank}).

Ranks join in one of three ways (`join`):
  * under `torchrun`, from its environment (`env://`);
  * from a FileStore that every rank opens, when this package spawns its
    own ranks (`spawn`: `msc_run --nproc N` and the tests);
  * from a TCPStore at host:port that rank 0 hosts (the multi-host
    control plane, `launch/distributed.py`).

The LM meshes are ("data", "model") over every rank (`make_local_mesh`)
and the reference's production shapes (`make_production_mesh`: 16 x 16,
or 2 x 16 x 16 with a "pod" dim).  A role over several mesh dims (the
MSC slice role of a (data, model) mesh) is one process group over those
dims, row-major (`axes_group`).

Nothing here runs at import: a mesh exists once `join` has run in every
rank.
"""
from __future__ import annotations

import datetime
import math
import os
import sys
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
         store_file=None, address=None,
         timeout=DEFAULT_TIMEOUT) -> torch.device:
    """Join this process to the default process group and return its
    device: gloo and `cpu` for device_type "cpu", NCCL and
    cuda:{local rank} for "cuda".

    With `store_file`, the ranks meet in a FileStore at that path; with
    `address` ("host:port"), in a TCPStore there that rank 0 hosts
    (rank and world_size given in both); with neither, in torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT).  A collective that waits longer than `timeout` raises
    in every rank that waits.  More ranks on a node than its cards
    raises ValueError.
    """
    import torch.distributed as dist

    if store_file is None and address is None:
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
    if address is not None:
        host, _, port = str(address).rpartition(":")
        store = dist.TCPStore(host or "localhost", int(port), world_size,
                              is_master=rank == 0, timeout=timeout)
    elif store_file is not None:
        store = dist.FileStore(str(store_file), world_size)
    else:
        dist.init_process_group(init_method="env://", **kw)
        return device
    dist.init_process_group(store=store, rank=rank, world_size=world_size,
                            **kw)
    return device


def leave() -> None:
    """Tear down the default process group (and with it every mesh's
    groups), if there is one.  Close the engines first: a CUDA graph
    that captured NCCL collectives holds its communicator, and a
    teardown while it lives waits for it."""
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


def _mesh(shape, names, device_type=None):
    """DeviceMesh of `shape` over the first prod(shape) ranks of the
    default process group (every rank when they are all of them)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    n = math.prod(shape)
    if n == dist.get_world_size():
        return init_device_mesh(device_type, tuple(shape),
                                mesh_dim_names=tuple(names))
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The reference's production mesh: ("data", "model") = (16, 16), or
    ("pod", "data", "model") = (2, 16, 16) with multi_pod, over the first
    256 (512) ranks.  Fewer ranks raise the reference's RuntimeError."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} devices for the production mesh, have {have} (one "
            f"rank per device: start {n} ranks)")
    return _mesh(shape, names, device_type)


def local_mesh_shape(n: int, model_axis: int = 1) -> tuple:
    """(data, model) over n ranks: model_axis clamped to [1, n] and down
    to a divisor of n, as the reference's `make_local_mesh` does."""
    model_axis = max(1, min(int(model_axis), n))
    while n % model_axis:
        model_axis -= 1
    return (n // model_axis, model_axis)


def make_local_mesh(model_axis: int = 1, device_type=None):
    """("data", "model") mesh over every rank of the default process group
    (`local_mesh_shape`)."""
    import torch.distributed as dist

    return _mesh(local_mesh_shape(dist.get_world_size(), model_axis),
                 ("data", "model"), device_type)


def axes_group(mesh, axes):
    """(process group, size, this rank's index) of the role `axes` (a
    tuple of mesh dim names): the mesh dim's own group for one dim; for
    several, one group per coordinate of the other dims, its ranks in
    row-major order over `axes` (so block k of a dim sharded over the
    role sits on the rank the reference's composite axis gives it).
    Made once per mesh and role; every rank makes every group (as
    `new_group` asks), in the same order, on real tensors even inside a
    `FakeTensorMode` (a traced step, `launch/dryrun.py`: the mesh's rank
    table is a real tensor).  None, 1, 0 for no dims."""
    axes = tuple(axes)
    if not axes:
        return None, 1, 0
    names = tuple(mesh.mesh_dim_names)
    if len(axes) == 1:
        return (mesh.get_group(axes[0]), mesh.size(names.index(axes[0])),
                mesh.get_local_rank(axes[0]))
    cache = mesh.__dict__.setdefault("_role_groups", {})
    if axes not in cache:
        import torch.distributed as dist
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        idx = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in idx]
        me = dist.get_rank()
        mine = None
        with unset_fake_temporarily():
            ranks = mesh.mesh.permute(rest + idx).reshape(
                -1, math.prod(mesh.size(i) for i in idx))
            for row in ranks.tolist():
                group = dist.new_group(row)
                if me in row:
                    mine = (group, len(row), row.index(me))
        cache[axes] = mine
    return cache[axes]


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
    exception ends the process with a nonzero code (and its traceback).
    Under NCCL a failed rank prints its traceback and exits at once:
    tearing the group down would wait for peers that wait for it."""
    if device_type == "cpu":
        torch.set_num_threads(1)
    device = join(device_type, rank=rank, world_size=world_size,
                  store_file=store_file, timeout=timeout)
    try:
        fn(device, *args)
    except BaseException:
        if device_type == "cuda":
            import traceback

            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)
        leave()
        raise
    leave()


def world_size(args) -> int:
    """The ranks a CLI's flags ask for: `--nproc`, torchrun's, or 1."""
    if args.nproc:
        return int(args.nproc)
    return int(os.environ["WORLD_SIZE"]) if launched_by_torchrun() else 1


def on_ranks(args, body):
    """body(args, device) where a CLI's flags put it:

      * with `--nproc N` (outside torchrun), in N new ranks, one per
        device (gloo on the CPU, NCCL on the cards); returns None once
        every rank has ended;
      * under torchrun, in this process as one rank of its group; returns
        body's result on rank 0 and None on the others;
      * else on the one device `args.device`; returns body's result.

    On ranks body prints from rank 0 only, and closes what holds the
    group's communicators (the engines' graphs) before it returns: the
    group is left after it."""
    device_type = torch.device(args.device).type
    if args.nproc and not launched_by_torchrun():
        import tempfile

        with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
            spawn(_body_on_rank, args.nproc, os.path.join(tmp, "store"),
                  body, args, device_type=device_type)
        return None
    if launched_by_torchrun():
        import torch.distributed as dist

        device = join(device_type)
        try:
            res = body(args, device)
            return res if dist.get_rank() == 0 else None
        finally:
            leave()
    from repro_torch.core.types import resolve_device

    return body(args, resolve_device(args.device))


def _body_on_rank(device, body, args):
    body(args, device)


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
