"""Serve a small LM with batched requests: prefill and greedy decode —
counterpart of `examples/serve_lm.py`.

Any of the ten arch ids of `repro_torch.configs` works (dense, MoE, SSM,
hybrid, VLM and encoder–decoder); the config is reduced (the CPU's
size).  Random weights from seed 0.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch gemma2-27b
  PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
  PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu \
      --arch recurrentgemma-2b
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.inputs import make_batch
from repro_torch.core import resolve_device
from repro_torch.models import build_model
from repro_torch.serving.engine import ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(model, params, args.batch,
                         args.prompt_len + args.gen)
    batch = make_batch(cfg, args.batch, args.prompt_len, kind="serve",
                       device=dev)
    t0 = time.perf_counter()
    out = engine.generate(batch, args.gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    engine.close()
    print(f"{cfg.name}: batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} → {tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s incl. capture)")
    print("sample:", out[0].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
