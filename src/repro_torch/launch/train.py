"""Fault-tolerant training driver (CLI) — counterpart of
`repro/launch/train.py`.

config → train step (µbatched) → checkpointed loop with watchdog and
crash-restart, on one device: the card (`--device cuda`, the default) or
the CPU (`--device cpu`, the reduced configs in seconds).  The reference's
flags and lines (`arch=… devices=… mesh=…`, `done: …`); exit code 0 when
the last loss is below the first.  As in the reference, `--microbatches`
is parsed and not passed on (the loop builds its step with the default).
On the card the run is deterministic (`torch.use_deterministic_algorithms`),
so a crash and resume gives the uninterrupted run's bits.

Training over ranks is not ported: `--production-mesh`, `--model-axis`
above 1 and a torchrun world of more than one process raise
NotImplementedError (ROADMAP.md queue 1 item 12 (d)).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --reduced --steps 50 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --reduced --steps 30 --fail-at 17 \\
      --device cpu    # injected crash + auto-restart
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 12 --batch 8 --seq 512    # on the card, published width
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from repro_torch.training.steps import ONE_DEVICE, TRAIN_MESH_TODO


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
                    help="16x16 mesh (training over ranks: not ported)")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' for the CPU)")
    return ap.parse_args(argv)


def _refuse_ranks(args) -> None:
    from repro_torch.launch.mesh import launched_by_torchrun

    world = int(os.environ.get("WORLD_SIZE", "1")) \
        if launched_by_torchrun() else 1
    if args.production_mesh or args.model_axis > 1 or world > 1:
        raise NotImplementedError(
            f"launch.train {TRAIN_MESH_TODO} (--production-mesh "
            f"{args.production_mesh}, --model-axis {args.model_axis}, "
            f"{world} processes)")


def deterministic(device) -> None:
    """Deterministic kernels on the card (cuBLAS's fixed workspace; the
    variable is read when CUDA starts, so set it before that)."""
    import torch

    if torch.device(device).type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)


def main(argv=None) -> int:
    args = parse_args(argv)
    _refuse_ranks(args)
    deterministic(args.device)
    from repro_torch.configs import get_config
    from repro_torch.core.types import resolve_device
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training.loop import TrainLoop, TrainLoopConfig

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    print(f"arch={cfg.name} devices=1 mesh={ONE_DEVICE} device={dev}")

    data = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=args.seq,
                              global_batch=args.batch, seed=0)
    loop_cfg = TrainLoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, compress_frac=args.compress,
        fail_at_step=args.fail_at)
    loop = TrainLoop(model, None, AdamWConfig(lr=args.lr), loop_cfg, data,
                     device=dev)

    t0 = time.time()
    loop.run_with_restarts()
    dt = time.time() - t0

    losses = [m["loss"] for m in loop.metrics]
    print(f"done: {len(loop.metrics)} steps in {dt:.1f}s  "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}  "
          f"stragglers={len(loop.straggler_events)}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"metrics": loop.metrics,
                       "stragglers": loop.straggler_events}, f)
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    raise SystemExit(main())
