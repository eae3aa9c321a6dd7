"""Train an LM end to end with the full substrate — counterpart of
`examples/train_lm.py`.

Default (`--size 10m`, the reference's name): qwen1.5-0.5b reduced, a
0.4M-parameter dense model, 200 steps, with checkpointing, auto-resume
and the straggler watchdog active.  --size 100m selects the reference's
wider config (82M parameters).  On the card by default; --device cpu
runs the 10m size on the CPU in seconds.

  PYTHONPATH=src python -m repro_torch.examples.train_lm
  PYTHONPATH=src python -m repro_torch.examples.train_lm --size 100m \\
      --steps 300
  PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \\
      --steps 20
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.core import resolve_device
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.launch.train import deterministic
from repro_torch.models import build_model, count_params
from repro_torch.optim import AdamWConfig
from repro_torch.training.loop import TrainLoop, TrainLoopConfig


def size_config(size: str):
    """The reference's configs: qwen1.5-0.5b reduced ("10m"), or widened
    ("100m")."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    if size == "100m":
        cfg = dataclasses.replace(
            cfg, n_layers=8, d_model=768, n_heads=12, n_kv_heads=12,
            head_dim=64, d_ff=2048, vocab_size=32768, loss_chunk=128)
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", choices=("10m", "100m"), default="10m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_example_train"))
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' for the CPU)")
    args = ap.parse_args(argv)
    deterministic(args.device)
    dev = resolve_device(args.device)

    cfg = size_config(args.size)
    model = build_model(cfg)
    n = count_params(model.defs())
    print(f"model: {cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab_size} "
          f"→ {n/1e6:.1f}M params")

    data = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=args.seq,
                              global_batch=args.batch, seed=0)
    loop = TrainLoop(
        model, None, AdamWConfig(lr=3e-4),
        TrainLoopConfig(total_steps=args.steps, ckpt_every=50,
                        ckpt_dir=args.ckpt_dir),
        data, device=dev)
    loop.run_with_restarts()
    losses = [m["loss"] for m in loop.metrics]
    print(f"loss: {losses[0]:.4f} → {losses[-1]:.4f} over "
          f"{len(losses)} steps (resumable from {args.ckpt_dir})")
    if not losses[-1] < losses[0]:
        raise SystemExit("the loss did not fall")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
