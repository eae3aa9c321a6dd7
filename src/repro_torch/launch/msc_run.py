"""MSC command line on torch — counterpart of `repro/launch/msc_run.py`.

Generates the paper's planted rank-1 tensor (§IV) on the device, runs
MSC (the sequential entry point, or the flat or grouped schedule; either
eigensolver: matrix-free or the explicit gram with `--gram`) and reports
recovery rate, similarity index (Eq. 6), cluster sizes, realized power
sweeps and wall time, with the same output lines as the reference.
`--batch B` serves B planted requests (seeds seed … seed+B−1) through
MSCServeEngine in one dispatch (CUDA graphs on the card), on one device
or on the mesh, and compares warm time with a loop of single-request
dispatches.

A mesh is one process per device (`launch/mesh.py`): `--nproc N` spawns
N ranks (gloo on the CPU, NCCL on N cards), and under `torchrun` every
process it starts is a rank.  `--mesh-shape` factors the ranks as the
reference does (flat: p or p,q; grouped: s, s,q or 3,s,q); rank 0
prints.  Without either the flat schedule runs on one device.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.msc_run --m 1000 --kernels
  PYTHONPATH=src python -m repro_torch.launch.msc_run --m 1000 --kernels \\
      --gram --batch 2
  PYTHONPATH=src python -m repro_torch.launch.msc_run --m 24 --device cpu \\
      --nproc 4 --mesh-shape 2,2 --epilogue ring
  PYTHONPATH=src python -m repro_torch.launch.msc_run --m 24 --device cpu \\
      --nproc 2 --batch 2 --mesh-shape 2
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.msc_run \\
      -- --m 1000 --kernels --mesh-shape 2,2

(torchrun reads the flags before `--` as its own; this CLI's `--m` would
be an ambiguous abbreviation of torchrun's.)
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (MSCConfig, PlantedSpec, build_msc_parallel,
                              make_planted_tensor, msc_sequential,
                              msc_similarity_matrices, planted_masks,
                              recovery_rate, similarity_index)
from repro_torch.launch.mesh import (make_msc_mesh, mesh_dims,
                                     msc_mesh_shape, on_ranks, parse_shape,
                                     world_size)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=60, help="cube tensor size")
    ap.add_argument("--gamma", type=float, default=None,
                    help="signal weight (default: m, as in paper Fig. 6)")
    ap.add_argument("--epsilon", type=float, default=None,
                    help="similarity threshold (default: Thm II.1-valid)")
    ap.add_argument("--schedule", default="flat",
                    choices=("sequential", "flat", "grouped"))
    ap.add_argument("--mesh-shape", default=None,
                    help="mesh factorization of the ranks, e.g. '2,2' = "
                         "(slice=2, inner=2): the inner dim shards the "
                         "within-slice rows; grouped takes 'slice,inner' "
                         "per mode group")
    ap.add_argument("--nproc", type=int, default=0,
                    help="spawn this many ranks, one per device (gloo on "
                         "the CPU, NCCL on the cards); torchrun's "
                         "processes join without it")
    ap.add_argument("--relayout", default="gspmd",
                    choices=("gspmd", "collective", "collective_stream"),
                    help="flat-schedule mode relayout over the mesh (one "
                         "local transpose on one device)")
    ap.add_argument("--epilogue", default="allgather",
                    choices=("allgather", "ring"),
                    help="similarity epilogue over the slice ranks: "
                         "all_gather of V or the ring of send/receive "
                         "steps (one |V Vᵀ| row sum on one device)")
    ap.add_argument("--power-iters", type=int, default=60,
                    help="power-iteration sweep cap")
    ap.add_argument("--power-tol", type=float, default=1e-2,
                    help="adaptive convergence tolerance; 0 = fixed trip "
                         "count")
    ap.add_argument("--precision", default="fp32",
                    choices=("fp32", "bf16_fp32"),
                    help="eigensolve operand precision policy")
    ap.add_argument("--gram", action="store_true",
                    help="paper-faithful explicit covariance (default: "
                         "matrix-free, beyond-paper)")
    ap.add_argument("--kernels", action="store_true",
                    help="route hot spots through the CUDA kernels")
    ap.add_argument("--batch", type=int, default=0,
                    help="serve this many independent planted requests "
                         "through MSCServeEngine in one batched dispatch "
                         "instead of one tensor (on the mesh with "
                         "--nproc / torchrun)")
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    return ap.parse_args(argv)


def _peak_gib(dev) -> str:
    """' peak_mem=X GiB' on a card (max_memory_allocated since the last
    reset), '' on the CPU."""
    if dev.type != "cuda":
        return ""
    return f" peak_mem={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}GiB"


def _allocated(dev) -> int:
    """Bytes of live device tensors (0 on the CPU)."""
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _timed(dev, fn):
    """(fn(), host seconds around work that ends in a device sync)."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (
        lambda _: None)
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def _run_batched(cfg: MSCConfig, spec: PlantedSpec, args, dev, mesh=None,
                 say=print) -> dict:
    """--batch B: serve B independent planted requests in one dispatch
    (on `mesh` when given: every rank makes the same requests) and report
    per-request quality, cold / warm / looped-warm times and the engine's
    compile counts; on a card also the device memory the live engine
    holds beside its reckoning (static buffers + graph pools; one rank's)
    and what each engine leaves once closed.  `say` prints (rank 0's
    print on a mesh).  Returns {"results", "recs", "sweeps", "cold",
    "warm", "loop_warm", "stats_cold", "stats_warm", "held", "reckoned",
    "left", "loop_left"}."""
    from repro_torch.serving import MSCServeEngine
    from repro_torch.serving.graphs import capture_stream

    tensors = [make_planted_tensor(
        torch.Generator(device=dev).manual_seed(args.seed + i), spec)
        for i in range(args.batch)]
    true_masks = planted_masks(spec, device=dev)
    engine = MSCServeEngine(cfg, max_batch=args.batch, device=dev,
                            mesh=mesh)
    if dev.type == "cuda":
        # the process's capture stream and its cuBLAS workspace, made once
        # and shared by every engine, are not the engine's memory
        capture_stream(dev)
    _reset_peak(dev)
    base = _allocated(dev)
    results, cold = _timed(dev, lambda: engine.run(tensors))
    stats_cold = engine.stats
    _, warm = _timed(dev, lambda: engine.run(tensors))
    stats_warm = engine.stats.delta(stats_cold)
    held = _allocated(dev) - base
    reckoned = engine.memory_reckoning()
    engine.close()
    left = _allocated(dev) - base
    peak = _peak_gib(dev)
    recs = [float(recovery_rate(true_masks, [r[j].mask for j in range(3)]))
            for r in results]
    sweeps = [[r[j].power_iters_run for j in range(3)] for r in results]
    for i, (rec, sw) in enumerate(zip(recs, sweeps)):
        say(f"  req {i}: rec={rec:.3f} "
              f"sizes={[r.size for r in results[i].modes]} sweeps={sw}")
    loop = MSCServeEngine(cfg, max_batch=1, device=dev, mesh=mesh)
    loop.run(tensors)
    _, loop_warm = _timed(dev, lambda: loop.run(tensors))
    loop.close()
    loop_left = _allocated(dev) - base
    say(f"mean rec={np.mean(recs):.3f} B={args.batch} "
          f"cold={cold:.3f}s warm={warm:.3f}s "
          f"looped-warm={loop_warm:.3f}s speedup={loop_warm / warm:.2f}x "
          f"(compiles: {stats_cold.compiles} cold, "
          f"{stats_warm.compiles} warm){peak}")
    if dev.type == "cuda":
        say(f"device memory held by the live engine: {held} B (reckoned: "
              f"static buffers {reckoned[0]} B + graph pools {reckoned[1]} "
              f"B); left once closed: {left} B (looped engine: "
              f"{loop_left} B)")
    return {"results": results, "recs": recs, "sweeps": sweeps,
            "cold": cold, "warm": warm, "loop_warm": loop_warm,
            "stats_cold": stats_cold, "stats_warm": stats_warm,
            "held": held, "reckoned": reckoned, "left": left,
            "loop_left": loop_left}


def run(args: argparse.Namespace):
    """Run the CLI's work and print its lines.  Returns one record per
    repeat, {"result": MSCResult, "rec", "sim", "t"}, or with --batch the
    dict of `_run_batched` (under torchrun rank 0's).  With --nproc the
    ranks run in new processes and this returns None once all have
    ended."""
    if args.schedule != "sequential":  # the reference's checks
        msc_mesh_shape(args.schedule, world_size(args),
                       parse_shape(args.mesh_shape))
    return on_ranks(args, _run)


def _run(args, dev, world=None):
    """The run on `dev`: on a mesh of every rank (`world`, by default the
    group's size) when the process group is up (rank 0 prints), else on
    one device."""
    import torch.distributed as dist

    on_mesh = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if on_mesh else 1
    say = print if not on_mesh or dist.get_rank() == 0 else (
        lambda *a, **k: None)
    m = args.m
    gamma = args.gamma if args.gamma is not None else float(m)
    l = max(1, m // 10)
    # Theorem II.1: sqrt(eps) <= 1/(m-l)
    eps = args.epsilon if args.epsilon is not None else 0.5 / (m - l) ** 2
    spec = PlantedSpec.paper(m, gamma)
    cfg = MSCConfig(epsilon=eps, power_iters=args.power_iters,
                    power_tol=args.power_tol, precision=args.precision,
                    matrix_free=not args.gram, epilogue=args.epilogue,
                    max_extraction_iters=m, use_kernels=args.kernels)

    say(f"MSC m={m}^3 gamma={gamma} eps={eps:.2e} l={l} "
        f"schedule={args.schedule} matrix_free={not args.gram} "
        f"power_tol={args.power_tol} precision={args.precision} "
        f"epilogue={args.epilogue} devices={world} device={dev}")

    if args.schedule == "sequential":
        if args.batch:
            raise SystemExit("--batch needs a parallel schedule (the "
                             "serving engine runs the flat schedule)")
        run_fn = lambda t: msc_sequential(t, cfg, device=dev)  # noqa: E731
    elif on_mesh:
        mesh = make_msc_mesh(args.schedule, parse_shape(args.mesh_shape),
                             dev.type)
        say(f"mesh: {mesh_dims(mesh)}")
        if args.batch:
            return _run_batched(cfg, spec, args, dev, mesh, say)
        kw = {"relayout": args.relayout} if args.schedule == "flat" else {}
        run_fn = build_msc_parallel(cfg, schedule=args.schedule, mesh=mesh,
                                    **kw)
    else:
        say("mesh: {'slice': 1}")
        if args.batch:
            return _run_batched(cfg, spec, args, dev)
        run_fn = build_msc_parallel(cfg, schedule=args.schedule, device=dev,
                                    relayout=args.relayout)

    records = []
    for r in range(args.repeats):
        gen = torch.Generator(device=dev).manual_seed(args.seed + r)
        tensor = make_planted_tensor(gen, spec)
        true_masks = planted_masks(spec, device=dev)
        _reset_peak(dev)
        result, t = _timed(dev, lambda: run_fn(tensor))
        peak = _peak_gib(dev)
        pred = [mr.mask for mr in result.modes]
        rec = float(recovery_rate(true_masks, pred))
        sim = float("nan")
        if say is print:  # the metric is rank 0's alone
            c_mats = msc_similarity_matrices(tensor, cfg, device=dev)
            sim = float(similarity_index(c_mats, pred))
            del c_mats
        del tensor
        sweeps = [int(mr.power_iters_run) for mr in result.modes]
        say(f"  run {r}: rec={rec:.3f} sim={sim:.3f} "
            f"sizes={[mr.size for mr in result.modes]} "
            f"t={t:.2f}s sweeps={sweeps}{peak}")
        records.append({"result": result, "rec": rec, "sim": sim, "t": t})

    say(f"mean rec={np.mean([x['rec'] for x in records]):.3f} "
        f"sim={np.mean([x['sim'] for x in records]):.3f} "
        f"t={np.mean([x['t'] for x in records]):.2f}s "
        f"(first run includes the kernel build)")
    return records


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
