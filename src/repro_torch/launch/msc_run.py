"""MSC command line on torch — counterpart of `repro/launch/msc_run.py`.

Generates the paper's planted rank-1 tensor (§IV) on the device, runs
MSC (the sequential entry point or the one-device flat schedule) and reports
recovery rate, similarity index (Eq. 6), cluster sizes, realized power
sweeps and wall time, with the same output lines as the reference.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.msc_run --m 1000 --kernels
  PYTHONPATH=src python -m repro_torch.launch.msc_run --m 24 --device cpu \\
      --schedule sequential
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (MSCConfig, PlantedSpec, build_msc_parallel,
                              make_planted_tensor, msc_sequential,
                              msc_similarity_matrices, planted_masks,
                              recovery_rate, resolve_device,
                              similarity_index)
from repro_torch.core.schedule import MULTI_DEVICE_TODO


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
                    help="mesh factorization; one device only takes '1'")
    ap.add_argument("--relayout", default="gspmd",
                    choices=("gspmd", "collective"),
                    help="flat-schedule mode relayout (one local transpose "
                         "on one device)")
    ap.add_argument("--epilogue", default="allgather",
                    choices=("allgather", "ring"),
                    help="similarity epilogue (one |V Vᵀ| row-sum on one "
                         "device)")
    ap.add_argument("--power-iters", type=int, default=60,
                    help="power-iteration sweep cap")
    ap.add_argument("--power-tol", type=float, default=1e-2,
                    help="adaptive convergence tolerance; 0 = fixed trip "
                         "count")
    ap.add_argument("--precision", default="fp32",
                    choices=("fp32", "bf16_fp32"),
                    help="eigensolve operand precision policy")
    ap.add_argument("--gram", action="store_true",
                    help="paper-faithful explicit covariance (not ported)")
    ap.add_argument("--kernels", action="store_true",
                    help="route hot spots through the CUDA kernels")
    ap.add_argument("--batch", type=int, default=0,
                    help="batched serving (not ported)")
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> list:
    """Run the CLI's work and print its lines.  Returns one record per
    repeat: {"result": MSCResult, "rec", "sim", "t"}."""
    if args.gram:
        raise NotImplementedError(
            "--gram: the explicit gram is not ported yet (ROADMAP.md, "
            "queue 2 item 5)")
    if args.batch:
        raise NotImplementedError(
            "--batch: batched serving is not ported yet (ROADMAP.md, "
            "queue 1 item 7)")
    if args.mesh_shape not in (None, "1"):
        raise NotImplementedError(f"--mesh-shape {args.mesh_shape}: "
                                  f"{MULTI_DEVICE_TODO}")
    dev = resolve_device(args.device)
    m = args.m
    gamma = args.gamma if args.gamma is not None else float(m)
    l = max(1, m // 10)
    # Theorem II.1: sqrt(eps) <= 1/(m-l)
    eps = args.epsilon if args.epsilon is not None else 0.5 / (m - l) ** 2
    spec = PlantedSpec.paper(m, gamma)
    cfg = MSCConfig(epsilon=eps, power_iters=args.power_iters,
                    power_tol=args.power_tol, precision=args.precision,
                    matrix_free=True, epilogue=args.epilogue,
                    max_extraction_iters=m, use_kernels=args.kernels)

    print(f"MSC m={m}^3 gamma={gamma} eps={eps:.2e} l={l} "
          f"schedule={args.schedule} matrix_free=True "
          f"power_tol={args.power_tol} precision={args.precision} "
          f"epilogue={args.epilogue} devices=1 device={dev}")

    if args.schedule == "sequential":
        run_fn = lambda t: msc_sequential(t, cfg, device=dev)  # noqa: E731
    else:
        print("mesh: {'slice': 1}")
        run_fn = build_msc_parallel(cfg, schedule=args.schedule, device=dev,
                                    relayout=args.relayout)

    records = []
    for r in range(args.repeats):
        gen = torch.Generator(device=dev).manual_seed(args.seed + r)
        tensor = make_planted_tensor(gen, spec)
        true_masks = planted_masks(spec, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        result = run_fn(tensor)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter() - t0
        pred = [mr.mask for mr in result.modes]
        rec = float(recovery_rate(true_masks, pred))
        c_mats = msc_similarity_matrices(tensor, cfg, device=dev)
        sim = float(similarity_index(c_mats, pred))
        del tensor, c_mats
        sweeps = [mr.power_iters_run for mr in result.modes]
        print(f"  run {r}: rec={rec:.3f} sim={sim:.3f} "
              f"sizes={[mr.size for mr in result.modes]} "
              f"t={t:.2f}s sweeps={sweeps}")
        records.append({"result": result, "rec": rec, "sim": sim, "t": t})

    print(f"mean rec={np.mean([x['rec'] for x in records]):.3f} "
          f"sim={np.mean([x['sim'] for x in records]):.3f} "
          f"t={np.mean([x['t'] for x in records]):.2f}s "
          f"(first run includes the kernel build)")
    return records


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
