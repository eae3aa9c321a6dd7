"""The system under test: the port's entry points, as the benchmark calls
them.

This module and the readers of the program's spans
(`portbench/metrics/*.py`, which import `repro_torch.spans` after the
window) are all of the benchmark that imports the program
(`repro_torch`), and this module only the entries a user calls:
`core.build_msc_parallel` for a solve (across cards on the flat
schedule's mesh from `launch.mesh`), `MSCContinuousEngine` for serving,
`core.schedule.build_mode_runner` for the eigensolve stage that
`eigensolve_roofline` times, and for a language model
`models.build_model` on the configuration's `ModelConfig`, its
parameters built (`models.params.build`) from the weights the harness
made, and `serving.ServeEngine`.  MSC answers come back to the host as
`reference.msc.ModeAnswer`s, one copy per solve.
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


def lm_config(cell, program=None):
    """The port's ModelConfig of an LM configuration: its "port" fields
    and "solver" settings, `program`'s fields over them."""
    from repro_torch.models import ModelConfig

    return ModelConfig(**{**cell.config["port"], **cell.config["solver"],
                          **(program or {})})


def lm_params(model, w: dict):
    """The model's parameter modules on the harness's weights `w`, named
    as `reference/lm.py:weight_specs` names them: a leaf of layer i of a
    stacked block or of the tail is row i of "layers.<leaf path>".  The
    port's RMSNorm multiplies by 1 + its `scale`, so a "scale" leaf is
    given the published multiplier − 1.  Every shape, the layer count
    too, must be the reference's."""
    from repro_torch.models.params import build

    defs = model.defs()
    period, n_scan = ((len(defs["layers"].defs), defs["layers"].n)
                      if "layers" in defs else (1, 0))
    layers = n_scan * period + len(defs.get("tail", ()))
    stacked = {len(t) for k, t in w.items() if k.startswith("layers.")}
    if stacked != {layers}:
        raise ValueError(f"the port has {layers} layers, the weights "
                         f"{sorted(stacked)}")

    def leaf(d, path):
        if path[0] == "layers":
            layer, rest = path[1] * period + int(path[2][1:]), path[3:]
        elif path[0] == "tail":
            layer, rest = n_scan * period + path[1], path[2:]
        else:
            layer, rest = None, path
        name = ".".join(("layers",) * (layer is not None) + rest)
        t = w[name] if layer is None else w[name][layer]
        if tuple(t.shape) != tuple(d.shape):
            raise ValueError(f"{name}: {tuple(t.shape)}, the port's "
                             f"{tuple(d.shape)}")
        return (t - 1.0 if rest[-1] == "scale" else t).to(d.dtype)

    return build(defs, leaf)


def lm_engine(cell, w: dict, batch: int, max_len: int, program=None):
    """The port's greedy `ServeEngine` of the configuration on the
    harness's weights, at (batch, max_len); `program`'s ModelConfig
    fields over the configuration's."""
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

    model = build_model(lm_config(cell, program))
    return ServeEngine(model, lm_params(model, w), batch, max_len)
