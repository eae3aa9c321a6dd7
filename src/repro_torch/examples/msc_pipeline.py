"""End to end: the paper's workload as a pipeline.

Chunked data production (the paper's "data produced on the processes
themselves": mode-1 slabs, no tensor materialized by one producer) →
MSC (flat schedule, one device) → quality metrics → a JSON report,
printed and, with `--out`, written to a file.  The reference runs the
schedule on a mesh of every local device; the port's meshes are one
process per device (`launch/msc_run.py --nproc N`).

  PYTHONPATH=src python -m repro_torch.examples.msc_pipeline          # m=96
  PYTHONPATH=src python -m repro_torch.examples.msc_pipeline --m 200
  PYTHONPATH=src python -m repro_torch.examples.msc_pipeline --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core import (MSCConfig, PlantedSpec, build_msc_parallel,
                              make_planted_tensor_chunked,
                              msc_similarity_matrices, planted_masks,
                              recovery_rate, resolve_device,
                              similarity_index)


def _synced(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=96)
    ap.add_argument("--gamma", type=float, default=None)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--power-iters", type=int, default=60)
    ap.add_argument("--out", default=None,
                    help="also write the JSON report to this file")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    m = args.m
    gamma = args.gamma if args.gamma is not None else float(m)
    l = max(1, m // 10)
    spec = PlantedSpec.paper(m, gamma)
    cfg = MSCConfig(epsilon=0.5 / (m - l) ** 2,
                    power_iters=args.power_iters, max_extraction_iters=m)

    # 1. chunked data production (mode-1 slabs, owner-computes)
    t0 = _synced(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    tensor = torch.cat([slab for _, slab in make_planted_tensor_chunked(
        gen, spec, n_chunks=args.chunks)], dim=0)
    t_data = _synced(dev) - t0

    # 2. MSC, flat schedule
    msc = build_msc_parallel(cfg, schedule="flat", device=dev)
    t0 = _synced(dev)
    result = msc(tensor)
    t_first = _synced(dev) - t0
    t0 = _synced(dev)
    result = msc(tensor)
    t_run = _synced(dev) - t0

    # 3. quality metrics (paper Eq. 6)
    pred = [mode.mask for mode in result.modes]
    rec = float(recovery_rate(planted_masks(spec), pred))
    sim = float(similarity_index(
        msc_similarity_matrices(tensor, cfg, device=dev), pred))

    report = {
        "m": m, "gamma": gamma, "epsilon": cfg.epsilon,
        "cluster_sizes": [mode.size for mode in result.modes],
        "recovery_rate": rec, "similarity_index": sim,
        "extraction_iters": [int(mode.n_iters) for mode in result.modes],
        "t_data_s": t_data, "t_first_run_s": t_first,
        "t_steady_run_s": t_run, "device": str(dev), "devices": 1,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    if rec != 1.0:
        raise RuntimeError("planted cluster not recovered")
    return report


if __name__ == "__main__":
    main()
