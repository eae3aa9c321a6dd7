#!/usr/bin/env python3
"""Where the port's main path spends its time on the card.

    PYTHONPATH=src python tools/torch_profile.py [--m 1000] [--precision fp32]
        [--schedule flat|sequential] [--gram]
    PYTHONPATH=src python tools/torch_profile.py --lm [--attn-impl chunked]

Builds the CLI's planted tensor (γ = m, seed 0, the CLI's default
config with kernels; `--gram` for the explicit-gram eigensolver) on the
card, solves it once unprofiled (warm-up), then once under
`torch.profiler` (CPU + CUDA activities), and prints the device time per
kernel name, the launch counts, the solve's host wall time and the
device's busy share (device kernel time over that wall time; device
events only, so an operator and the kernels it launches are not counted
twice), the device time by stage (gram formation, power sweeps and λ,
similarity epilogue, unfolding copies and the rest, and the idle time),
and the operators with the most device time by input shape.  Needs a
CUDA card; prints the card's name and power limit first.

`--lm` profiles LM serving instead: whisper-tiny at its published size,
batch 16, prompt 32, 16 generated tokens (`launch/serve.py`'s engine,
random weights from seed 0), warmed up once, then one `generate` under
the profiler, with the same report and LM stages (flash_attention,
matmuls, elementwise and reductions, copies and casts).  `--attn-impl`
picks the attention route (default `pallas`, the CUDA kernel).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def _dev_us(e, self_only=False):
    for name in (("self_device_time_total", "self_cuda_time_total")
                 if self_only else ("device_time_total", "cuda_time_total")):
        if hasattr(e, name):
            return float(getattr(e, name))
    return 0.0


# stage of a device kernel, by the first substring of its name that matches
STAGES = (("gram_kernel", "formation (batched_gram)"),
          ("power_kernel", "sweeps (power_iter)"),
          ("gemv", "sweeps and λ (cuBLAS gemv on C, Rayleigh)"),
          ("gemm", "sweeps and λ (cuBLAS gemv on C, Rayleigh)"),
          ("abs_rowsum", "epilogue (abs_rowsum)"),  # abs_rowsum_kernel
          ("copy", "unfolding copies and casts"),
          ("elementwise", "elementwise, reductions, extraction"),
          ("reduce", "elementwise, reductions, extraction"))


# flash_kernel (fp32 tile route), flash_small_kernel (small-sq route) and
# flash_mma_kernel (bf16 tile route) are all attention
LM_STAGES = (("flash_", "attention (flash_attention)"),
             ("gemm", "matmuls (cuBLAS)"),
             ("gemv", "matmuls (cuBLAS)"),
             ("copy", "copies and casts"),
             ("elementwise", "elementwise and reductions"),
             ("reduce", "elementwise and reductions"),
             ("softmax", "elementwise and reductions"))


def _stage(name: str, stages=STAGES) -> str:
    low = name.lower()
    for key, stage in stages:
        if key in low:
            return stage
    return "other"


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=1000)
    ap.add_argument("--precision", default="fp32")
    ap.add_argument("--schedule", default="flat")
    ap.add_argument("--gram", action="store_true",
                    help="explicit-gram eigensolver (paper Alg. 1)")
    ap.add_argument("--lm", action="store_true",
                    help="profile whisper-tiny serving instead of MSC")
    ap.add_argument("--attn-impl", default="pallas",
                    choices=("pallas", "chunked"),
                    help="attention route of --lm")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())

    if args.lm:
        return profile_lm(torch, args.attn_impl)

    from repro_torch.kernels import gram as kgram
    from repro_torch.kernels import power_iter as kpi
    from repro_torch.kernels import ring as kring
    from repro_torch.core import (MSCConfig, PlantedSpec, build_msc_parallel,
                                  make_planted_tensor, msc_sequential)

    m, l = args.m, max(1, args.m // 10)
    cfg = MSCConfig(epsilon=0.5 / (m - l) ** 2, precision=args.precision,
                    max_extraction_iters=m, use_kernels=True,
                    matrix_free=not args.gram)
    tensor = make_planted_tensor(
        torch.Generator(device="cuda").manual_seed(0),
        PlantedSpec.paper(m, float(m)))
    solve = (build_msc_parallel(cfg, device="cuda")
             if args.schedule == "flat"
             else lambda t: msc_sequential(t, cfg, device="cuda"))
    solve(tensor)  # warm-up: kernel build, allocator, cuBLAS handles
    kpi.launches = kring.launches = kgram.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        result = solve(tensor)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"profiled solve (m={m}, {args.schedule}, {args.precision}, "
          f"{'gram' if args.gram else 'matrix-free'}): sweeps "
          f"{[mr.power_iters_run for mr in result.modes]}, launches "
          f"power_iter={kpi.launches} abs_rowsum={kring.launches} "
          f"batched_gram={kgram.launches}")
    report(prof, wall, STAGES)
    return 0


def profile_lm(torch, attn_impl: str) -> int:
    """One warm whisper-tiny `generate` under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import serve

    args = serve.parse_args(["--arch", "whisper-tiny", "--batch", "16",
                             "--prompt-len", "32", "--gen", "16",
                             "--attn-impl", attn_impl])
    engine, batch = serve.build(args)
    engine.generate(batch, args.gen)  # warm-up: library load, cuBLAS
    kfa.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        engine.generate(batch, args.gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"profiled generate (whisper-tiny, batch {args.batch}, prompt "
          f"{args.prompt_len}, {args.gen} tokens, {attn_impl}, "
          f"{engine.model.cfg.compute_dtype}): launches "
          f"flash_attention={kfa.launches}")
    report(prof, wall, LM_STAGES)
    return 0


def report(prof, wall: float, stages_of) -> None:
    """Device time per stage and per kernel, busy share and the top
    operators of one profiled window of `wall` host seconds."""
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    total_us = sum(_dev_us(e, self_only=True) for e in events)
    print(f"wall {wall * 1e3:.1f} ms, device kernel time "
          f"{total_us / 1e3:.1f} ms, busy share {total_us / 1e6 / wall:.3f}")
    if total_us == 0:
        print("device time: not measured (the profiler saw no device "
              "activity)")
    stages = {}
    for e in events:
        st = _stage(e.key, stages_of)
        stages[st] = stages.get(st, 0.0) + _dev_us(e, self_only=True)
    print("device time by stage:")
    for st, us in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3:9.2f} ms  {st}")
    print(f"  {wall * 1e3 - total_us / 1e3:9.2f} ms  idle (wall minus "
          "device kernel time)")
    top = sorted(events, key=lambda e: _dev_us(e, True), reverse=True)[:12]
    for e in top:
        us = _dev_us(e, True)
        if us > 0:
            print(f"  {us / 1e3:9.2f} ms  {100 * us / total_us:5.1f}%  "
                  f"x{e.count:<5d} {e.key[:90]}")
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == DeviceType.CPU and _dev_us(e, True) > 0]
    print("operators by device time and input shapes:")
    for e in sorted(ops, key=lambda e: _dev_us(e, True), reverse=True)[:8]:
        print(f"  {_dev_us(e, True) / 1e3:9.2f} ms  x{e.count:<5d} {e.key} "
              f"{str(e.input_shapes)[:80]}")


if __name__ == "__main__":
    sys.exit(main())
