"""Quickstart: Multi-Slice Clustering of a planted third-order tensor.

Generates the paper's synthetic model T = γ·w⊗u⊗v + Z (§IV), runs the
sequential MSC (paper Alg. 1) and the flat schedule (Alg. 2) and checks
that both find the planted tricluster.  The flat schedule runs on one
device here; over a mesh it runs one process per device
(`launch/msc_run.py --nproc N`, `launch/mesh.py`).

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import (MSCConfig, PlantedSpec, build_msc_parallel,
                              make_planted_tensor, msc_sequential,
                              msc_similarity_matrices, planted_masks,
                              recovery_rate, resolve_device,
                              similarity_index)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    dev = resolve_device(ap.parse_args(argv).device)
    m, gamma = 40, 40.0
    spec = PlantedSpec.paper(m, gamma)          # cube m³, cluster l = m/10
    cfg = MSCConfig(epsilon=0.5 / (m - m // 10) ** 2,   # Thm II.1-valid
                    power_iters=60, max_extraction_iters=m)

    tensor = make_planted_tensor(torch.Generator(device=dev).manual_seed(0),
                                 spec)
    true_masks = planted_masks(spec)
    print(f"tensor {tuple(tensor.shape)} on {dev}, planted cluster sizes "
          f"{spec.cluster_sizes}, γ={gamma}")

    # --- sequential (paper Alg. 1) ---
    res_seq = msc_sequential(tensor, cfg, device=dev)
    print("sequential cluster sizes:", [mode.size for mode in res_seq.modes])

    # --- parallel (paper Alg. 2, flat schedule, one device) ---
    res_par = build_msc_parallel(cfg, schedule="flat", device=dev)(tensor)
    print("parallel   cluster sizes:", [mode.size for mode in res_par.modes])

    pred = [mode.mask for mode in res_par.modes]
    rec = float(recovery_rate(true_masks, pred))
    sim = float(similarity_index(
        msc_similarity_matrices(tensor, cfg, device=dev), pred))
    print(f"recovery rate = {rec:.3f}   similarity index = {sim:.3f}")

    agree = all(torch.equal(s.mask, p.mask)
                for s, p in zip(res_seq.modes, res_par.modes))
    print("sequential == parallel:", agree)
    if not (agree and rec == 1.0):
        raise RuntimeError("the planted tricluster was not found by both")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
