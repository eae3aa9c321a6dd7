"""Batched LM serving CLI — counterpart of `repro/launch/serve.py`.

Prefill, then greedy decode with the KV cache, on one device, with
random weights from seed 0.  The reference's flags, plus `--device`
(default `cuda`; `cpu` runs the kernels' plain versions) and
`--attn-impl` (default: the config's own, `chunked`; `pallas` sends
the encoder's self-attention and every cross-attention through the
hand-written CUDA kernel).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
      --batch 16 --prompt-len 32 --gen 16 --attn-impl pallas
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
      --reduced --device cpu --attn-impl pallas
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.inputs import make_batch
from repro_torch.core.types import resolve_device
from repro_torch.kernels import flash_attention as kfa
from repro_torch.models import build_model
from repro_torch.serving.engine import ServeEngine

MESH_TODO = ("serving over a device mesh is not ported yet: ROADMAP.md, "
             "queue 1 item 9 (rest) (the port serves on one device)")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--attn-impl", default=None,
                    choices=("full", "chunked", "pallas"),
                    help="attention route (default: the config's own); "
                         "pallas is the CUDA kernel")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """(engine, batch) for the arguments: the model at the arch's
    published size (or reduced), random weights from seed 0 and a batch
    from seed 0, on the requested device."""
    if args.production_mesh or args.model_axis != 1:
        raise NotImplementedError(MESH_TODO)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(model, params, args.batch,
                         args.prompt_len + args.gen)
    batch = make_batch(cfg, args.batch, args.prompt_len, kind="serve",
                       device=dev)
    return engine, batch


def run(args: argparse.Namespace) -> dict:
    """Serve one batch.  Returns the generated ids, the host seconds and
    the engine's device timings of `generate`, the config and the
    flash_attention launches of the run."""
    engine, batch = build(args)
    n0 = kfa.launches
    t0 = time.perf_counter()
    out = engine.generate(batch, args.gen)
    dt = time.perf_counter() - t0
    return {"tokens": out, "seconds": dt, "timings": engine.timings,
            "cfg": engine.model.cfg, "flash_launches": kfa.launches - n0}


def main(argv=None) -> int:
    args = parse_args(argv)
    res = run(args)
    cfg, out, dt, tm = res["cfg"], res["tokens"], res["seconds"], \
        res["timings"]
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen}")
    print(f"generated shape={tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("first sequence:", out[0].tolist())
    print(f"attn_impl={cfg.attn_impl} compute_dtype={cfg.compute_dtype} "
          f"prefill_ms={tm['prefill_ms']:.3f} "
          f"decode_ms_per_token={tm['decode_ms'] / max(args.gen, 1):.3f} "
          f"flash_attention launches={res['flash_launches']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
