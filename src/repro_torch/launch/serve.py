"""Batched LM serving CLI — counterpart of `repro/launch/serve.py`.

Prefill, then greedy decode with the KV cache, with random weights from
seed 0.  The reference's flags, plus `--device` (default `cuda`; `cpu`
runs the kernels' plain versions), `--attn-impl` (default: the config's
own, `chunked`; `pallas` sends the encoder's self-attention and every
cross-attention through the hand-written CUDA kernel) and `--nproc`.

Without `--production-mesh` or `--model-axis` it serves on one device.
With either it serves on a (data, model) mesh of ranks, one process per
device (`launch/mesh.py`): `--nproc N` spawns N ranks (gloo on the CPU,
NCCL on N cards), and under `torchrun` every process it starts is a
rank; `--model-axis` is clamped to a divisor of the rank count, as the
reference clamps it, and `--production-mesh` needs 256 ranks.  Every rank
serves the same batch and rank 0 prints.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
      --batch 16 --prompt-len 32 --gen 16 --attn-impl pallas
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
      --reduced --device cpu --attn-impl pallas
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --reduced --device cpu --nproc 4 --model-axis 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
      --batch 16 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-1b-a400m --reduced --device cpu --nproc 4 \\
      --model-axis 2   # expert parallel over "model"
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
from repro_torch.launch.mesh import (make_local_mesh, make_production_mesh,
                                     mesh_dims, on_ranks)
from repro_torch.models import build_model
from repro_torch.serving.engine import ServeEngine


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
    ap.add_argument("--nproc", type=int, default=0,
                    help="spawn this many ranks, one per device (gloo on "
                         "the CPU, NCCL on the cards); torchrun's "
                         "processes join without it")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    return ap.parse_args(argv)


def build(args: argparse.Namespace, dev=None, mesh=None):
    """(engine, batch) for the arguments: the model at the arch's
    published size (or reduced), random weights from seed 0 and a batch
    from seed 0, on the requested device, or on `mesh` (this rank's
    shards of the same weights) on `dev`."""
    dev = resolve_device(args.device) if dev is None else dev
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(model, params, args.batch,
                         args.prompt_len + args.gen, mesh=mesh)
    batch = make_batch(cfg, args.batch, args.prompt_len, kind="serve",
                       device=dev)
    return engine, batch


def run(args: argparse.Namespace):
    """Serve one batch and print the reference's lines (rank 0's on a
    mesh).  Returns the generated ids, the host seconds and the engine's
    device timings of `generate`, the config, the mesh's dims (None on
    one device) and the flash_attention launches of the run; under
    torchrun rank 0's (None on the other ranks); with --nproc the ranks
    run in new processes and this returns None."""
    return on_ranks(args, _serve_and_report)


def _serve(args: argparse.Namespace, dev) -> dict:
    """One batch served on `dev`: on the production mesh with
    --production-mesh (which raises with fewer than 256 ranks), on the
    (data, model) mesh of every rank when the process group is up, else
    on one device (--model-axis clamps to the one rank, as the
    reference's make_local_mesh does)."""
    import torch.distributed as dist

    mesh = None
    if args.production_mesh:
        mesh = make_production_mesh(device_type=dev.type)
    elif dist.is_available() and dist.is_initialized():
        mesh = make_local_mesh(args.model_axis, dev.type)
    engine, batch = build(args, dev, mesh)
    n0 = kfa.launches
    t0 = time.perf_counter()
    out = engine.generate(batch, args.gen)
    dt = time.perf_counter() - t0
    engine.close()
    return {"tokens": out, "seconds": dt, "timings": engine.timings,
            "cfg": engine.model.cfg, "flash_launches": kfa.launches - n0,
            "mesh": None if mesh is None else mesh_dims(mesh)}


def _serve_and_report(args: argparse.Namespace, dev) -> dict:
    import torch.distributed as dist

    res = _serve(args, dev)
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_rank() == 0:
        report(args, res)
    return res


def report(args, res) -> None:
    """The reference's lines, and the port's timings and launches."""
    cfg, out, dt, tm = res["cfg"], res["tokens"], res["seconds"], \
        res["timings"]
    if res["mesh"] is not None:
        print(f"mesh: {res['mesh']}")
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen}")
    print(f"generated shape={tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("first sequence:", out[0].tolist())
    print(f"attn_impl={cfg.attn_impl} compute_dtype={cfg.compute_dtype} "
          f"prefill_ms={tm['prefill_ms']:.3f} "
          f"decode_ms_per_token={tm['decode_ms'] / max(args.gen, 1):.3f} "
          f"flash_attention launches={res['flash_launches']}")


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
