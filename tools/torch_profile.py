#!/usr/bin/env python3
"""Where the port's main path spends its time on the card.

    PYTHONPATH=src python tools/torch_profile.py [--m 1000] [--precision fp32]
        [--schedule flat|sequential] [--gram]
        [--mesh-shape 1|1,1 [--relayout gspmd] [--epilogue allgather]]
    PYTHONPATH=src python tools/torch_profile.py --lm [--attn-impl chunked]
        [--arch whisper-tiny]
    PYTHONPATH=src python tools/torch_profile.py --train
        [--arch qwen1.5-0.5b] [--microbatches 1] [--mesh-shape 1,1]
    PYTHONPATH=src python tools/torch_profile.py --continuous \
        [--chunks-per-step 1]

Builds the CLI's planted tensor (γ = m, seed 0, the CLI's default
config with kernels; `--gram` for the explicit-gram eigensolver) on the
card, solves it once unprofiled (warm-up), then once under
`torch.profiler` (CPU + CUDA activities), and prints the device time per
kernel name, the launch counts, the solve's host wall time and the
device's busy share (device kernel time over that wall time; device
events only, so an operator and the kernels it launches are not counted
twice), the device time by stage and the operators with the most device
time by input shape.  The stages are the program's spans
(`repro_torch.spans`, recorded while the profiler records): the device
time of `msc.unfold`, `msc.eigensolve` (the gram's formation included),
`msc.epilogue`, `msc.extract` and `msc.collective` by kind, each the
stream's time between CUDA events at the span's ends, so a stage counts
the stream's idle inside it and the collectives lie inside the other
stages.  The host reads are the profiled solve's `msc.gate_reads`: one a
gate chunk and one more a mode.  The power kernel's launches are counted
by route, from the device's kernel names and from the program's counter
`kernels.power_resident`, as a share of `power_iter.launches`.  With `--mesh-shape` the flat schedule
runs over a DeviceMesh of one NCCL rank (a FileStore in a temporary
directory; `--relayout`, `--epilogue`), the path of `chip_smoke.py`
phase 8.  Needs a CUDA card; prints the card's name and power limit
first.

`--continuous` profiles continuous MSC serving instead: the skewed mix
of `chip_smoke.py` phase 5c (32 planted requests at m = 200, every 8th
γ = 2, the rest γ = 300; tol 3e-3, a probe every 8 sweeps, cap 240;
kernels, fp32) through MSCContinuousEngine (8 slots,
`--chunks-per-step`) and through the static MSCServeEngine (B = 8), each
warmed up, then one warm run of each under the profiler with the same
report, its stages the engine's spans (`serve.refill`: evictions,
admissions and the refill graph; `serve.chunk`: the step graph and its
per-tick read) and its gate reads (`msc.gate_reads`, the static
engine's gated loop), and the device time of one replay of each of the
continuous engine's two CUDA graphs (CUDA events over 20 replays: the
step, and the refill with inputs that move nothing).

`--train` profiles one warm train step of `chip_smoke.py` phase 17
instead: `--arch` (qwen1.5-0.5b as in 17a, or granite-moe-1b-a400m as
in 17c) at its published size, bf16 compute on fp32 masters, batch 8,
seq 512 of `SyntheticLMDataset`, `build_train_step` with
`--microbatches` (default 1), under deterministic algorithms as phase
17 runs it; one step warms up, the next is profiled.  Its kernels are
put in stages by where they were launched: the super-blocks' forward,
their backward, their recompute in the backward (remat), the loss chunks
(forward, recompute and backward), AdamW and the rest, and in each by
kind (matmuls, copies and casts, elementwise and reductions); then the
same step timed in pieces with CUDA events (the forward, the forward and
backward, AdamW alone).  With `--mesh-shape d,m` (one NCCL rank: 1,1)
the step runs on a (data, model) DeviceMesh, the path of `chip_smoke.py`
phase 18a: the NCCL kernels are their own kind ("collectives"), the
step's collectives are counted by kind, and the device time of NCCL
kernels and of device-to-device memcpys (what NCCL runs among one rank)
is printed, as it is for one device.

`--lm` profiles LM serving instead: `--arch` (default whisper-tiny) at
its published size, batch 16, prompt 32, 16 generated tokens
(`launch/serve.py`'s engine, random weights from seed 0), warmed up
once, then one `generate` under the profiler, with the same report and
LM stages (flash_attention, matmuls, elementwise and reductions, copies
and casts).  The decode steps replay the engine's captured step (one
CUDA graph per token).  `--attn-impl` picks the attention route
(default `pallas`, the CUDA kernel).
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


# the stages of a solve and of serving: the program's spans
SOLVE_SPANS = ("msc.unfold", "msc.eigensolve", "msc.epilogue", "msc.extract")
SERVE_SPANS = ("serve.refill", "serve.chunk")


# flash_kernel (fp32 tile route), flash_small_kernel (small-sq route) and
# flash_mma_kernel (bf16 tile route) are all attention
LM_STAGES = (("flash_", "attention (flash_attention)"),
             ("gemm", "matmuls (cuBLAS)"),
             ("gemv", "matmuls (cuBLAS)"),
             ("nvjet", "matmuls (cuBLAS)"),
             ("copy", "copies and casts"),
             ("elementwise", "elementwise and reductions"),
             ("reduce", "elementwise and reductions"),
             ("softmax", "elementwise and reductions"))


def _stage(name: str, stages) -> str:
    low = name.lower()
    for key, stage in stages:
        if key in low:
            return stage
    return "other"


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=1000)
    ap.add_argument("--precision", default="fp32")
    ap.add_argument("--schedule", default="flat")
    ap.add_argument("--gram", action="store_true",
                    help="explicit-gram eigensolver (paper Alg. 1)")
    ap.add_argument("--lm", action="store_true",
                    help="profile LM serving (--arch) instead of MSC")
    ap.add_argument("--arch", default=None,
                    help="the arch --lm serves (whisper-tiny) or --train "
                         "trains (qwen1.5-0.5b)")
    ap.add_argument("--attn-impl", default="pallas",
                    choices=("pallas", "chunked"),
                    help="attention route of --lm")
    ap.add_argument("--train", action="store_true",
                    help="profile one train step of --arch (phase 17)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient accumulation of --train")
    ap.add_argument("--continuous", action="store_true",
                    help="profile continuous MSC serving against the "
                         "static engine instead of one solve")
    ap.add_argument("--chunks-per-step", type=int, default=1,
                    help="gate chunks per continuous step")
    ap.add_argument("--mesh-shape", default=None,
                    help="the flat schedule over a mesh of one NCCL rank "
                         "of this shape ('1' or '1,1')")
    ap.add_argument("--relayout", default="gspmd",
                    choices=("gspmd", "collective", "collective_stream"))
    ap.add_argument("--epilogue", default="allgather",
                    choices=("allgather", "ring"))
    args = ap.parse_args(argv)
    # --train runs deterministically: cuBLAS reads this when CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())

    if args.train and args.mesh_shape:
        return profile_train_mesh(torch, args)
    if args.train:
        return profile_train(torch, args.arch or "qwen1.5-0.5b",
                             args.microbatches)
    if args.lm:
        return profile_lm(torch, args.attn_impl, args.arch or "whisper-tiny")
    if args.continuous:
        return profile_continuous(torch, args.chunks_per_step)

    from repro_torch.core import (MSCConfig, PlantedSpec, build_msc_parallel,
                                  make_planted_tensor, msc_sequential)

    m, l = args.m, max(1, args.m // 10)
    cfg = MSCConfig(epsilon=0.5 / (m - l) ** 2, precision=args.precision,
                    max_extraction_iters=m, use_kernels=True,
                    matrix_free=not args.gram, epilogue=args.epilogue)
    tensor = make_planted_tensor(
        torch.Generator(device="cuda").manual_seed(0),
        PlantedSpec.paper(m, float(m)))
    if args.mesh_shape:
        return profile_mesh(torch, args, cfg, tensor)
    solve = (build_msc_parallel(cfg, device="cuda")
             if args.schedule == "flat"
             else lambda t: msc_sequential(t, cfg, device="cuda"))
    return profile_solve(torch, solve, tensor,
                         f"m={m}, {args.schedule}, {args.precision}, "
                         f"{'gram' if args.gram else 'matrix-free'}")


def profile_mesh(torch, args, cfg, tensor) -> int:
    """The flat schedule over a mesh of one NCCL rank, profiled like one
    solve; the process group is torn down whatever happens."""
    import tempfile

    from repro_torch.core import build_msc_parallel
    from repro_torch.launch.mesh import (join, leave, make_msc_mesh,
                                         parse_shape)

    with tempfile.TemporaryDirectory(prefix="torch_profile_") as tmp:
        try:
            join("cuda", rank=0, world_size=1,
                 store_file=os.path.join(tmp, "store"))
            mesh = make_msc_mesh("flat", parse_shape(args.mesh_shape))
            solve = build_msc_parallel(cfg, mesh=mesh,
                                       relayout=args.relayout)
            return profile_solve(
                torch, solve, tensor,
                f"m={args.m}, flat over mesh {args.mesh_shape} (one NCCL "
                f"rank), {args.relayout}, {args.epilogue}, "
                f"{args.precision}, "
                f"{'gram' if args.gram else 'matrix-free'}")
        finally:
            leave()


def span_stages(names) -> dict:
    """Device seconds of the profiled window's spans named in `names`, and
    of `msc.collective` by kind (`repro_torch.spans`)."""
    from repro_torch import spans

    out = {}
    for s in spans.recorded().spans:
        if s.device_s is None:
            continue
        if s.name == "msc.collective":
            key = f"msc.collective ({s.attrs['kind']})"
        elif s.name in names:
            key = s.name
        else:
            continue
        out[key] = out.get(key, 0.0) + s.device_s * 1e6
    return out


def span_count(name: str) -> int:
    """The profiled window's counter `name` (`repro_torch.spans`)."""
    from repro_torch import spans

    return spans.recorded().counters.get(name, 0)


def power_routes(prof, stage: str, launches: int) -> None:
    """The power kernel's launches in the window by route: the device's
    kernels by name (replays of CUDA graphs included) and the program's
    counter `kernels.power_resident` (eager launches and captures) beside
    `power_iter.launches`; all of them run inside `stage`."""
    names = {"resident": "power_resident_kernel",
             "streaming": "power_stream_kernel", "general": "power_kernel<"}
    counts = {k: 0 for k in names}
    for e in _device_events(prof):
        for k, frag in names.items():
            if frag in e.key:
                counts[k] += e.count
                break
    total = sum(counts.values())
    share = f"{100 * counts['resident'] / total:.1f}%" if total else "n/a"
    print(f"power kernel in {stage}: {total} launches on the device "
          f"(resident {counts['resident']}, streaming {counts['streaming']}, "
          f"general {counts['general']}; resident share {share}); "
          f"kernels.power_resident {span_count('kernels.power_resident')} of "
          f"{launches} power_iter launches")


def profile_solve(torch, solve, tensor, label: str) -> int:
    """A warm-up solve and one under the profiler with the report."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import gram as kgram
    from repro_torch.kernels import power_iter as kpi
    from repro_torch.kernels import ring as kring

    solve(tensor)  # warm-up: kernel build, allocator, cuBLAS handles
    kpi.launches = kring.launches = kgram.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        result = solve(tensor)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"profiled solve ({label}): sweeps "
          f"{[int(mr.power_iters_run) for mr in result.modes]}, launches "
          f"power_iter={kpi.launches} abs_rowsum={kring.launches} "
          f"batched_gram={kgram.launches}")
    report(prof, wall, span_stages(SOLVE_SPANS))
    power_routes(prof, "msc.eigensolve", kpi.launches)
    print(f"host reads per solve: {span_count('msc.gate_reads')} (the "
          "profiled solve's msc.gate_reads)")
    return 0


def _replay_ms(torch, step, reps: int = 20) -> float:
    """Device milliseconds per replay of a captured step (CUDA events)."""
    step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        step()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profile_continuous(torch, chunks_per_step: int) -> int:
    """One warm run of the skewed mix through each engine under the
    profiler, and one replay of each of the continuous engine's graphs."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import MSCConfig, PlantedSpec, make_planted_tensor
    from repro_torch.kernels import power_iter as kpi
    from repro_torch.kernels import ring as kring
    from repro_torch.serving import MSCContinuousEngine, MSCServeEngine
    from repro_torch.serving.msc_engine import _control

    m, n, b, slow_every = 200, 32, 8, 8
    cfg = MSCConfig(epsilon=3e-4, power_tol=3e-3, power_iters=240,
                    power_check_every=8, use_kernels=True)
    tensors = [make_planted_tensor(
        torch.Generator(device="cuda").manual_seed(i),
        PlantedSpec.paper(m, 2.0 if i % slow_every == 0 else 300.0))
        for i in range(n)]
    engines = {
        f"continuous (slots {b}, {chunks_per_step} chunk(s) per step)":
        MSCContinuousEngine(cfg, slots=b, chunks_per_step=chunks_per_step,
                            device="cuda"),
        f"static (B = {b})": MSCServeEngine(cfg, max_batch=b,
                                            device="cuda")}
    for name, eng in engines.items():
        eng.run(tensors)  # warm-up: kernel build, captures
        eng.run(tensors)
        kpi.launches = kring.launches = 0
        before = eng.stats
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            eng.run(tensors)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        s = eng.stats.delta(before)
        print(f"profiled warm run, {name}: {n} requests at m={m}, "
              f"{s.dispatches} dispatches ({s.chunk_steps} chunk steps, "
              f"{s.refills} refills), occupancy {s.occupancy:.3f}, launches "
              f"power_iter={kpi.launches} abs_rowsum={kring.launches}")
        report(prof, wall, span_stages(SERVE_SPANS))
        power_routes(prof, "serve.chunk" if "continuous" in name
                     else "the static engine's gate chunks", kpi.launches)
        print(f"gate reads (msc.gate_reads): {span_count('msc.gate_reads')}"
              f"; per-tick reads of the finished flags (serve.chunk): "
              f"{s.chunk_steps}")
    cont = next(iter(engines.values()))
    (tb,) = cont._tables.values()
    st = tb.state
    step_ms = _replay_ms(torch, st.programs[0])
    fill = np.ones((b, 3), np.int32)
    st.ctl.copy_(torch.from_numpy(_control(  # perm = identity, nothing new
        np.arange(b), np.zeros(b), np.ones(b), fill, fill)))
    refill_ms = _replay_ms(torch, st.programs[1])
    static_b, pools = cont.memory_reckoning()
    print(f"one replay: step {step_ms:.4f} ms, refill {refill_ms:.4f} ms "
          f"(device, CUDA events over 20 replays); slot table {static_b} B "
          f"static + {pools} B graph pool")
    for eng in engines.values():
        eng.close()
    return 0


def profile_lm(torch, attn_impl: str, arch: str) -> int:
    """One warm `generate` of `arch` under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import serve

    args = serve.parse_args(["--arch", arch, "--batch", "16",
                             "--prompt-len", "32", "--gen", "16",
                             "--attn-impl", attn_impl])
    engine, batch = serve.build(args)
    engine.generate(batch, args.gen)  # warm-up: library load, capture
    kfa.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        engine.generate(batch, args.gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"profiled generate ({arch}, batch {args.batch}, prompt "
          f"{args.prompt_len}, {args.gen} tokens, {attn_impl}, "
          f"{engine.model.cfg.compute_dtype}): launches "
          f"flash_attention={kfa.launches}, decode graphs captured "
          f"{engine.captures}, prefill {engine.timings['prefill_ms']:.3f} ms, "
          f"decode {engine.timings['decode_ms'] / args.gen:.3f} ms per token")
    report(prof, wall, kernel_stages(prof, LM_STAGES))
    return 0


# where a train step's kernels were launched (the ranges profile_train
# opens), innermost first
TRAIN_RANGES = ("train/superblock.recompute", "train/superblock",
                "train/loss_chunk.recompute", "train/loss_chunk",
                "train/adamw")


def _kind(name: str) -> str:
    low = name.lower()
    if "nccl" in low:
        return "collectives"
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "sm90_xmma")):
        return "matmuls"
    if "copy" in low:
        return "copies and casts"
    return "elementwise and reductions"


def _region(e, fwd_region):
    """The range a CPU op ran in: its innermost TRAIN_RANGES ancestor; in
    the autograd engine, the range of the forward op its node came from
    (by sequence number) + " backward"; else "other"."""
    node = e
    while node is not None:
        if node.name in TRAIN_RANGES:
            return node.name[len("train/"):]
        if node.name.startswith("autograd::engine::evaluate_function"):
            return fwd_region.get(node.sequence_nr, "other") + " backward"
        node = node.cpu_parent
    return "other"


def _wrap_ranges(torch):
    """Open a TRAIN_RANGES range around each super-block, loss chunk and
    AdamW update (a super-block or chunk run inside the autograd engine
    is its recompute).  Returns a function that undoes it."""
    from torch.profiler import record_function

    from repro_torch.models import transformer
    from repro_torch.training import steps

    saved = (transformer._superblock, transformer._chunk_nll,
             steps.adamw_update)

    def ranged(fn, name):
        def inner(*a, **kw):
            tag = name + (".recompute" if torch._C._current_autograd_node()
                          is not None else "")
            with record_function("train/" + tag):
                return fn(*a, **kw)
        return inner

    transformer._superblock = ranged(saved[0], "superblock")
    transformer._chunk_nll = ranged(saved[1], "loss_chunk")
    steps.adamw_update = ranged(saved[2], "adamw")

    def undo():
        (transformer._superblock, transformer._chunk_nll,
         steps.adamw_update) = saved

    return undo


def profile_train_mesh(torch, args) -> int:
    """`profile_train` on a (data, model) mesh of one NCCL rank; the
    process group is torn down whatever happens."""
    import tempfile

    from repro_torch.launch.mesh import _mesh, join, leave, parse_shape

    with tempfile.TemporaryDirectory(prefix="torch_profile_") as tmp:
        try:
            join("cuda", rank=0, world_size=1,
                 store_file=os.path.join(tmp, "store"))
            mesh = _mesh(parse_shape(args.mesh_shape), ("data", "model"))
            return profile_train(torch, args.arch or "qwen1.5-0.5b",
                                 args.microbatches, mesh)
        finally:
            leave()


def profile_train(torch, arch: str, microbatches: int, mesh=None) -> int:
    """One warm train step of `arch` under the profiler, by stage (on
    `mesh` when given)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset, device_put_batch
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.sharding.activation import activation_sharding
    from repro_torch.training.steps import (_grads, build_train_step,
                                            make_train_state)

    torch.use_deterministic_algorithms(True)
    cfg = get_config(arch)
    model = build_model(cfg)
    state = make_train_state(
        model, torch.Generator(device="cuda").manual_seed(0), mesh=mesh)
    step, _, bspecs = build_train_step(model, mesh, AdamWConfig(),
                                       microbatches=microbatches)
    shards = step.shards
    data = SyntheticLMDataset(cfg.vocab_size, 512, 8, seed=0)
    batches = [device_put_batch(data.batch(i), "cuda",
                                bspecs if mesh is not None else None, shards)
               for i in range(4)]
    state, met = step(state, batches[0])  # warm-up
    met["loss"].item()
    undo = _wrap_ranges(torch)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, met = step(state, batches[1])
            met["loss"].item()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        undo()
    where = "one device" if mesh is None else \
        f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} of NCCL ranks"
    print(f"profiled train step ({arch}, batch 8, seq 512, "
          f"{cfg.compute_dtype} on fp32 masters, {microbatches} "
          f"microbatch(es), {where}): loss {met['loss'].item():.6f}, peak "
          f"{torch.cuda.max_memory_allocated()} B")
    if shards is not None:
        print(f"collectives of the step: {dict(shards.counts)}, of which "
              f"gradient reductions {dict(shards.grad_counts)}")
    report(prof, wall, kernel_stages(prof, LM_STAGES))
    print(f"device time of NCCL kernels {_named_us(prof, 'nccl') / 1e3:.2f} "
          f"ms and of device-to-device memcpys (NCCL's among one rank, "
          f"and the copies' own) "
          f"{_named_us(prof, 'memcpy dtod') / 1e3:.2f} ms")

    events = prof.events()
    fwd_region = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.sequence_nr >= 0 and \
                not _in_engine(e):
            fwd_region.setdefault(e.sequence_nr, _region(e, {}))
    by = {}
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        region = _region(e, fwd_region)
        for k in e.kernels:
            key = (region, _kind(k.name))
            by[key] = by.get(key, 0.0) + k.duration
    total = sum(by.values())
    print(f"device time by where it was launched (kernels of CPU ops, "
          f"{total / 1e3:.1f} ms):")
    for (region, kind), us in sorted(by.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3:9.2f} ms  {region:32s} {kind}")

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    plist = list(state.params.parameters())
    b = batches[2]

    def fwd():
        if shards is None:
            model.loss_fn(state.params, b)
            return
        with activation_sharding(shards):
            shards.gather_params(plist)
            try:
                model.loss_fn(state.params, b)
            finally:
                shards.memo = None

    def fwd_bwd():
        return _grads(model, state.params, b, shards)[2]

    grads = fwd_bwd()
    t_fwd, t_fb = timed(fwd), timed(fwd_bwd)
    t_opt = timed(lambda: adamw_update(grads, state.opt, state.params,
                                       AdamWConfig(), shards))
    t_step = timed(lambda: step(state, batches[3]))
    print(f"CUDA events (ms, mean of 3 warm calls): forward {t_fwd:.2f}, "
          f"forward + backward {t_fb:.2f}, AdamW {t_opt:.2f}, step "
          f"{t_step:.2f}")
    return 0


def _in_engine(e) -> bool:
    node = e
    while node is not None:
        if node.name.startswith("autograd::engine::evaluate_function"):
            return True
        node = node.cpu_parent
    return False


def _named_us(prof, part: str) -> float:
    """Device microseconds of the events whose name holds `part`."""
    from torch.autograd import DeviceType

    return sum(_dev_us(e, self_only=True) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and part in e.key.lower())


def _device_events(prof) -> list:
    """The profiled window's device events (the train ranges' and the
    program's spans on the device timeline are not kernels)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("train/", "msc.", "serve."))]


def kernel_stages(prof, stages_of) -> dict:
    """Device microseconds by stage, a kernel's stage by its name."""
    stages = {}
    for e in _device_events(prof):
        st = _stage(e.key, stages_of)
        stages[st] = stages.get(st, 0.0) + _dev_us(e, self_only=True)
    return stages


def report(prof, wall: float, stages: dict) -> None:
    """Device time per stage (microseconds by name, `kernel_stages` or
    `span_stages`) and per kernel, busy share and the top operators of
    one profiled window of `wall` host seconds."""
    from torch.autograd import DeviceType

    events = _device_events(prof)
    total_us = sum(_dev_us(e, self_only=True) for e in events)
    print(f"wall {wall * 1e3:.1f} ms, device kernel time "
          f"{total_us / 1e3:.1f} ms, busy share {total_us / 1e6 / wall:.3f}")
    if total_us == 0:
        print("device time: not measured (the profiler saw no device "
              "activity)")
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
