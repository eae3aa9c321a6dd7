"""Fault-tolerant training driver (CLI) — counterpart of
`repro/launch/train.py`.

config → train step (µbatched) → checkpointed loop with watchdog and
crash-restart, on one device — the card (`--device cuda`, the default)
or the CPU (`--device cpu`, the reduced configs in seconds) — or on a
(data, model) mesh of ranks, one process per device (`launch/mesh.py`):
`--nproc N` spawns N ranks (gloo on the CPU, NCCL on N cards), and under
`torchrun` every process it starts is a rank.  `--model-axis` is clamped
to a divisor of the rank count and `--production-mesh` needs 256 ranks,
as in the reference.  The reference's flags and lines (`arch=…
devices=… mesh=…`, `done: …`, printed by rank 0); exit code 0 when the
last loss is below the first.  As in the reference, `--microbatches` is
parsed and not passed on (the loop builds its step with the default).
On the card the run is deterministic (`torch.use_deterministic_algorithms`),
so a crash and resume gives the uninterrupted run's bits.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --reduced --steps 50 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --reduced --steps 30 --fail-at 17 \\
      --device cpu    # injected crash + auto-restart
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --reduced --steps 8 --batch 4 --seq 32 --device cpu --nproc 4 \\
      --model-axis 2  # a (2, 2) mesh of four gloo ranks
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 12 --batch 8 --seq 512    # on the card, published width
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen1.5-0.5b --batch 8 --seq 512 --model-axis 2   # 4 cards
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from repro_torch.training.steps import ONE_DEVICE


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="family-preserving reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compress", type=float, default=None,
                    help="top-k gradient compression fraction (e.g. 0.01)")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (tests the restart "
                         "path)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (needs 256 ranks)")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--nproc", type=int, default=0,
                    help="spawn this many ranks, one per device (gloo on "
                         "the CPU, NCCL on the cards); torchrun's "
                         "processes join without it")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' for the CPU)")
    return ap.parse_args(argv)


def deterministic(device) -> None:
    """Deterministic kernels on the card (cuBLAS's fixed workspace; the
    variable is read when CUDA starts, so set it before that)."""
    import torch

    if torch.device(device).type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)


def _train(args: argparse.Namespace, dev) -> int:
    """The run on `dev`: on the production mesh with --production-mesh
    (which raises with fewer than 256 ranks), on the (data, model) mesh of
    every rank when the process group is up, else on one device
    (--model-axis clamps to the one rank, as the reference's
    make_local_mesh does).  Rank 0 prints; returns the exit code."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch.mesh import (make_local_mesh,
                                         make_production_mesh, mesh_dims)
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training.loop import TrainLoop, TrainLoopConfig

    deterministic(dev)
    ranks = dist.is_available() and dist.is_initialized()
    mesh = None
    if args.production_mesh:
        mesh = make_production_mesh(device_type=dev.type)
    elif ranks:
        mesh = make_local_mesh(args.model_axis, dev.type)
    first = not ranks or dist.get_rank() == 0
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    if first:
        print(f"arch={cfg.name} devices={mesh.size() if mesh else 1} "
              f"mesh={mesh_dims(mesh) if mesh else ONE_DEVICE} "
              f"device={dev}")

    data = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=args.seq,
                              global_batch=args.batch, seed=0)
    loop_cfg = TrainLoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, compress_frac=args.compress,
        fail_at_step=args.fail_at)
    loop = TrainLoop(model, mesh, AdamWConfig(lr=args.lr), loop_cfg, data,
                     device=dev)

    t0 = time.time()
    loop.run_with_restarts()
    dt = time.time() - t0

    losses = [m["loss"] for m in loop.metrics]
    if first:
        print(f"done: {len(loop.metrics)} steps in {dt:.1f}s  "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}  "
              f"stragglers={len(loop.straggler_events)}")
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                json.dump({"metrics": loop.metrics,
                           "stragglers": loop.straggler_events}, f)
    return 0 if losses[-1] < losses[0] else 1


def _train_on_rank(args: argparse.Namespace, dev) -> int:
    rc = _train(args, dev)
    if args.nproc and rc:  # a spawned rank: its exit code is the run's
        raise SystemExit(rc)
    return rc


def main(argv=None) -> int:
    import torch

    from repro_torch.launch.mesh import on_ranks

    args = parse_args(argv)
    if torch.device(args.device).type == "cuda":
        # before CUDA starts here and in every rank spawned from here
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    rc = on_ranks(args, _train_on_rank)
    return rc or 0


if __name__ == "__main__":
    raise SystemExit(main())
