"""Elastic restore of MSC serving — counterpart of the MSC part of
`repro/launch/elastic.py`.

When a job comes back on another number of devices, the mesh is derived
from the ranks live now and the newest checkpoint is restored onto it:
the engine's checkpoints are mesh-independent (carries trimmed to the
true bucket size, blocks rebuilt from the stashed tensors), so a solve
checkpointed on 2 ranks finishes on 1, and the reverse.

`restore_after_host_loss` is the survivor's side of the multi-host
control plane (`launch/distributed.py`).  `ElasticTrainer` rebuilds the
training loop on the ranks live at each attempt: the (data, model) mesh
over the current process group (`make_elastic_mesh`), onto which the
newest checkpoint is resumed (the checkpoint holds whole leaves; each
rank cuts its shards for the mesh live now), so a run checkpointed on
four ranks goes on with two.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


def best_mesh_shape(n_devices: int, prefer_model: int = 1) -> Tuple[int, int]:
    """Largest (data, model) factorization of the live device count: the
    model dim stays at `prefer_model` when it divides, else the largest
    divisor below it."""
    model = min(prefer_model, n_devices)
    while n_devices % model:
        model -= 1
    return n_devices // model, model


def best_msc_shape(n_devices: int, prefer_inner: int = 1) -> Tuple[int, int]:
    """Largest (slice, inner) factorization of the live device count: the
    inner (row-shard) dim stays at `prefer_inner` when it divides, else
    the largest divisor below it; the slice dim takes the rest."""
    inner = min(max(1, prefer_inner), n_devices)
    while n_devices % inner:
        inner -= 1
    return n_devices // inner, inner


def _group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def make_elastic_mesh(prefer_model: int = 1, device_type=None):
    """The ("data", "model") mesh over every rank of the current process
    group, shaped by `best_mesh_shape`; None (one device) without a
    group."""
    if not _group_up():
        return None
    import torch.distributed as dist

    from repro_torch.launch.mesh import _mesh

    return _mesh(best_mesh_shape(dist.get_world_size(), prefer_model),
                 ("data", "model"), device_type)


def make_elastic_msc_mesh(prefer_inner: int = 1, device_type=None):
    """The flat MSC mesh over every rank of the current process group,
    shaped by `best_msc_shape`; None (one device) without a group."""
    if not _group_up():
        return None
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_msc_mesh

    return make_msc_mesh("flat",
                         best_msc_shape(dist.get_world_size(), prefer_inner),
                         device_type)


def restore_msc_engine(directory: str, *, device="cuda",
                       device_type: Optional[str] = None, **restore_kwargs):
    """Restore an MSCContinuousEngine onto the ranks live now: the newest
    restorable checkpoint's mesh gives the inner degree to keep, the
    world size the rest (one device, `device`, without a process
    group)."""
    from repro_torch.checkpoint.store import (checkpoint_extra,
                                              latest_restorable)
    from repro_torch.serving.msc_engine import MSCContinuousEngine

    step = latest_restorable(directory, verify_sha=False)
    if step is None:
        raise FileNotFoundError(
            f"no restorable engine checkpoint under {directory!r}")
    prefer_inner = 1
    for axis, size in checkpoint_extra(directory, step).get("mesh", []):
        if axis == "inner":
            prefer_inner = int(size)
    mesh = make_elastic_msc_mesh(prefer_inner, device_type)
    return MSCContinuousEngine.restore(directory, mesh=mesh, device=device,
                                       **restore_kwargs)


def restore_after_host_loss(directory: str, *, device="cuda",
                            **restore_kwargs):
    """The master's restore after a worker of the control plane died:
    the newest committed checkpoint (format 2, or 1) onto the master's
    own device, with no mesh.  The process group still exists with the
    dead peer in it, so this never goes through `make_elastic_msc_mesh`
    (which would build a mesh over the whole world) nor touches the
    group.  The step's device-layout carries are trimmed on import, so
    masks and sweeps resume bit for bit."""
    from repro_torch.serving.msc_engine import MSCContinuousEngine

    return MSCContinuousEngine.restore(directory, mesh=None, device=device,
                                       **restore_kwargs)


@dataclasses.dataclass
class ElasticTrainer:
    """Builds a `TrainLoop` from the ranks live now at each `run()` (one
    attempt: it auto-resumes the newest checkpoint); the outer restart
    controller calls it again after a failure, possibly on fewer
    ranks.  Without a process group it trains on `device`."""

    model: Any
    opt_cfg: Any
    loop_cfg: Any
    dataset: Any
    prefer_model: int = 1
    device: Any = "cuda"

    def run(self):
        import torch

        from repro_torch.training.loop import TrainLoop

        mesh = make_elastic_mesh(self.prefer_model,
                                 torch.device(self.device).type)
        loop = TrainLoop(self.model, mesh, self.opt_cfg, self.loop_cfg,
                         self.dataset, device=self.device)
        state = loop.run()
        return loop, state
