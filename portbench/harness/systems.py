"""The system under test: the port's entry points, as the benchmark calls
them.

Only this module imports the program (`repro_torch`), and only the
entries a user calls: `core.build_msc_parallel` for a solve (across
cards on the flat schedule's mesh from `launch.mesh`),
`MSCContinuousEngine` for serving, and `core.schedule.build_mode_runner`
for the eigensolve stage that `eigensolve_roofline` times.  Answers come
back to the host as `reference.msc.ModeAnswer`s, one copy per solve.
"""
from __future__ import annotations

import numpy as np
import torch

from reference.msc import MODE_PERMS, ModeAnswer


def solver_settings(cell) -> dict:
    """The configuration's solver settings under the mix's route: what
    the program is built with and the reference reads."""
    return {**cell.config["solver"], **cell.traffic.get("route", {})}


def msc_config(cell):
    """The program's MSCConfig of the cell."""
    from repro_torch.core import MSCConfig

    return MSCConfig(**solver_settings(cell))


def join_mesh(cell, device, rank: int, world: int, store):
    """(device, mesh) of this rank: the process group joined through the
    FileStore at `store`, and the flat schedule's mesh of the mix."""
    import datetime

    from repro_torch.launch.mesh import join, make_msc_mesh

    dev = join(device.type, rank=rank, world_size=world, store_file=store,
               timeout=datetime.timedelta(seconds=150))
    return dev, make_msc_mesh("flat", tuple(cell.traffic["mesh"]), dev.type)


def leave_mesh() -> None:
    from repro_torch.launch.mesh import leave

    leave()


def _answers(modes) -> list:
    """Three ModeAnswers from a result's device tensors, in one copy."""
    parts = []
    for mr in modes:
        parts += [mr.d.float(), mr.lambdas.float(), mr.mask.float(),
                  torch.as_tensor(mr.power_iters_run).float().reshape(1)]
    host = torch.cat(parts).cpu().numpy()
    out, at = [], 0
    for mr in modes:
        m = mr.d.shape[-1]
        d, lam, mask = (host[at:at + m], host[at + m:at + 2 * m],
                        host[at + 2 * m:at + 3 * m])
        out.append(ModeAnswer(mask=mask > 0.5, d=d.copy(), lam=lam.copy(),
                              sweeps=int(host[at + 3 * m])))
        at += 3 * m + 1
    return out


def solver(cell, device, mesh=None):
    """tensor → [ModeAnswer] * 3 through `build_msc_parallel` (the flat
    schedule on one device, or over `mesh`)."""
    from repro_torch.core import build_msc_parallel

    cfg = msc_config(cell)
    if mesh is None:
        fn = build_msc_parallel(cfg, schedule="flat", device=device)
    else:
        fn = build_msc_parallel(cfg, schedule="flat", mesh=mesh,
                                relayout=cell.traffic.get("relayout",
                                                          "gspmd"))

    def solve(tensor):
        return _answers(fn(tensor).modes)

    return solve


def host_answers(result) -> list:
    """Three ModeAnswers of a result the engine returned on the host."""
    return [ModeAnswer(mask=np.asarray(mr.mask.numpy(), bool),
                       d=mr.d.numpy().astype(np.float32),
                       lam=mr.lambdas.numpy().astype(np.float32),
                       sweeps=int(mr.power_iters_run)) for mr in result.modes]


def engine(cell, device):
    """The continuous serving engine of the configuration."""
    from repro_torch.serving import MSCContinuousEngine

    e = cell.config["engine"]
    return MSCContinuousEngine(
        msc_config(cell), slots=e["slots"],
        chunks_per_step=e["chunks_per_step"],
        bucket_quantum=e["bucket_quantum"], device=device)


def engine_counters(eng) -> dict:
    """The engine's `ServeStats` counters as a dict."""
    import dataclasses

    return dataclasses.asdict(eng.stats)


def mode_stages(cell, tensor, device) -> list:
    """Each mode's eigensolve and epilogue stage
    (`core.schedule.build_mode_runner` on one device) timed by CUDA
    events on the mode's unfolding of `tensor`: the second of two calls.
    Returns [{"shape", "sweeps", "seconds"}] per mode."""
    from repro_torch.core.schedule import ModeSchedule, build_mode_runner

    run = build_mode_runner(ModeSchedule(msc_config(cell)))
    out = []
    for perm in MODE_PERMS:
        block = tensor.permute(perm).contiguous()
        valid = torch.ones(block.shape[0], dtype=torch.bool, device=device)
        run(block, valid)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        _, _, iters = run(block, valid)
        end.record()
        end.synchronize()
        out.append({"shape": tuple(block.shape),
                    "sweeps": int(torch.amax(iters)),
                    "seconds": start.elapsed_time(end) / 1e3})
        del block
    return out
