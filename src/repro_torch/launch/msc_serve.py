"""Batched MSC serving CLI — counterpart of `repro/launch/msc_serve.py`.

Generates a stream of independent planted-tensor MSC requests with mixed
shapes, serves it through `MSCServeEngine` (shape buckets, one set of
CUDA graphs per bucket, fixed-size microbatches) twice, cold then warm,
and reports the bucket and capture behaviour plus batched-versus-looped
throughput, with the reference's output lines.  With `--continuous` the
same stream is also driven through `MSCContinuousEngine` as a streaming
arrival simulation (`simulate_continuous`: Poisson arrivals,
`--arrival-rate` per scheduler tick), after every bucket is warmed off
the clock, and the decode loop's occupancy, eviction and queue-wait
counters are reported; the serving tiers' flags attach the result
cache and warm starts (`--cache-dir`, `--cache-max-bytes`,
`--warm-start`), the SLO scheduler (`--priority-mix`, `--slo-chunks`,
`--deadline-chunks`, `--no-preempt`, `--bucket-policy`) and
checkpoints (`--checkpoint-dir`, `--ckpt-every`, `--restore`).
`--epilogue auto` and `--chunks-per-step auto` resolve per bucket from
the roofline models on the device's spec; `--autotune` times the power
kernel's routes and the models' proposals per bucket as captured graphs,
winners persisted under `<--checkpoint-dir>/autotune`.  The
reference's flags and defaults, plus `--device` (default `cuda`; `cpu`
runs the same steps eagerly) and `--nproc`.  `--mesh-shape p` or `p,q` serves on a flat mesh of ranks, one
process per device (`launch/mesh.py`): `--nproc N` spawns N ranks (gloo
on the CPU, NCCL on N cards), and under `torchrun` every process it
starts is a rank; every rank serves the same stream and rank 0 prints.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.msc_serve
  PYTHONPATH=src python -m repro_torch.launch.msc_serve --device cpu \\
      --sizes 14,19 --requests 6 --max-batch 2
  PYTHONPATH=src python -m repro_torch.launch.msc_serve --continuous \\
      --arrival-rate 1.5 --slow-every 4 --slots 4
  PYTHONPATH=src python -m repro_torch.launch.msc_serve --continuous \\
      --epilogue auto --chunks-per-step auto --autotune
  PYTHONPATH=src python -m repro_torch.launch.msc_serve --device cpu \\
      --nproc 4 --mesh-shape 2,2 --continuous --slots 4
  PYTHONPATH=src python -m repro_torch.launch.msc_serve --device cpu \\
      --continuous --priority-mix 0:0.5,1:1.5 --slo-chunks 32 \\
      --slow-every 8 --cache-dir /tmp/msc_cache --warm-start
  PYTHONPATH=src torchrun --nproc-per-node 4 \\
      -m repro_torch.launch.msc_serve -- --mesh-shape 4 --continuous
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (MSCConfig, PlantedSpec, make_planted_tensor,
                              planted_masks, recovery_rate)
from repro_torch.launch.mesh import (make_msc_mesh, mesh_dims,
                                     msc_mesh_shape, on_ranks, parse_shape,
                                     world_size)
from repro_torch.serving import (LoadShedError, MSCContinuousEngine,
                                 MSCResultCache, MSCServeEngine)



def build_request_stream(sizes, n_requests: int, seed: int,
                         slow_every: int = 0, gamma_slow: float = 2.0,
                         device="cpu", gamma_fast=None):
    """n_requests planted cubes cycling through `sizes` (mixed buckets),
    request i from a generator seeded with seed + i on `device`; with
    slow_every > 0, every slow_every-th request is a near-noise slow
    converger (γ = gamma_slow; the others γ = gamma_fast, by default
    max(m, 40))."""
    specs, tensors = [], []
    for i in range(n_requests):
        m = sizes[i % len(sizes)]
        gamma = gamma_slow if slow_every and i % slow_every == 0 \
            else float(max(m, 40) if gamma_fast is None else gamma_fast)
        specs.append(PlantedSpec.paper(m, gamma=gamma))
        gen = torch.Generator(device=device).manual_seed(seed + i)
        tensors.append(make_planted_tensor(gen, specs[-1]))
    return specs, tensors


def simulate_continuous(engine: MSCContinuousEngine, tensors, *,
                        arrival_rate: float, seed: int, priority_rates=None,
                        deadline_chunks=None):
    """Drive the decode loop under Poisson arrivals.

    Inter-arrival gaps are Exponential(1/arrival_rate) in scheduler
    ticks, drawn from `numpy.random.RandomState(seed)` as the reference
    draws them; each tick submits everything that has arrived, then
    advances the scheduler one tick.  With `priority_rates` ({class:
    arrivals per tick}) each request draws its class in proportion to
    the rates and the total rate is their sum; `deadline_chunks` rides
    through to submit().  Submits the engine sheds (`LoadShedError`) are
    dropped and counted.  Returns (results by input index, ticks, wall
    seconds, shed count).
    """
    rng = np.random.RandomState(seed)
    if priority_rates:
        classes = sorted(priority_rates)
        rates = np.asarray([priority_rates[c] for c in classes], float)
        arrival_rate = float(rates.sum())
        prio = [classes[i] for i in
                rng.choice(len(classes), size=len(tensors),
                           p=rates / rates.sum())]
    else:
        prio = [0] * len(tensors)
    arrivals = np.cumsum(rng.exponential(1.0 / max(arrival_rate, 1e-9),
                                         len(tensors)))
    results, rid_of = {}, {}
    tick, nxt, shed = 0, 0, 0
    t0 = time.perf_counter()
    while nxt < len(tensors) or engine.has_work():
        while nxt < len(tensors) and arrivals[nxt] <= tick:
            try:
                rid_of[engine.submit(tensors[nxt], priority=prio[nxt],
                                     deadline_chunks=deadline_chunks)] = nxt
            except LoadShedError:
                shed += 1
            nxt += 1
        if engine.has_work():
            for rid, res in engine.step().items():
                results[rid_of[rid]] = res
        tick += 1
    return results, tick, time.perf_counter() - t0, shed


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="16,21,33",
                    help="comma-separated cube sizes the stream cycles "
                         "through (three values = a 3-bucket stream)")
    ap.add_argument("--requests", type=int, default=9)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="microbatch size B (one set of graphs per bucket)")
    ap.add_argument("--bucket-quantum", type=int, default=8,
                    help="request dims round up to multiples of this")
    ap.add_argument("--mesh-shape", default=None,
                    help="flat-mesh factorization of the ranks, e.g. '4,2' "
                         "= (slice=4, inner=2)")
    ap.add_argument("--nproc", type=int, default=0,
                    help="spawn this many ranks, one per device (gloo on "
                         "the CPU, NCCL on the cards); torchrun's "
                         "processes join without it")
    ap.add_argument("--epilogue", default="allgather",
                    choices=("allgather", "ring", "auto"),
                    help="'auto' resolves per bucket from the roofline "
                         "models")
    ap.add_argument("--precision", default="fp32",
                    choices=("fp32", "bf16_fp32"))
    ap.add_argument("--power-tol", type=float, default=1e-2)
    ap.add_argument("--no-loop-compare", action="store_true",
                    help="skip the B=1 looped-baseline timing")
    ap.add_argument("--continuous", action="store_true",
                    help="also stream the requests through the "
                         "continuous-batching engine")
    ap.add_argument("--slots", type=int, default=None,
                    help="continuous slot-table size (default: max-batch)")
    ap.add_argument("--chunks-per-step", default="1",
                    help="gate chunks per continuous step, or 'auto' (the "
                         "roofline pick from the measured sweep histogram)")
    ap.add_argument("--autotune", action="store_true",
                    help="continuous mode: time the power kernel's routes "
                         "and the models' proposals per bucket as captured "
                         "graphs; winners persist under "
                         "<--checkpoint-dir>/autotune")
    ap.add_argument("--no-donate", action="store_true",
                    help="refused: the port updates the slot state in "
                         "place, so there is no donation to turn off")
    ap.add_argument("--arrival-rate", type=float, default=2.0,
                    help="mean Poisson arrivals per scheduler tick "
                         "(continuous mode)")
    ap.add_argument("--priority-mix", default=None,
                    help="per-class Poisson arrival rates, e.g. "
                         "'0:0.5,1:1.5' (class 0 most urgent); overrides "
                         "--arrival-rate with the sum")
    ap.add_argument("--slo-chunks", type=int, default=None,
                    help="shed submits whose predicted queue wait "
                         "exceeds this many chunks")
    ap.add_argument("--deadline-chunks", type=int, default=None,
                    help="per-request deadline in scheduler ticks "
                         "(misses are counted)")
    ap.add_argument("--no-preempt", action="store_true",
                    help="turn preempt-to-host off")
    ap.add_argument("--bucket-policy", default="weighted",
                    choices=("weighted", "all"),
                    help="'weighted' runs one bucket a tick by queue-depth "
                         "credit, 'all' every bucket")
    ap.add_argument("--slow-every", type=int, default=0,
                    help="every Nth request is a near-noise slow "
                         "converger (0 = homogeneous stream)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="continuous mode: checkpoint the engine here every "
                         "--ckpt-every gate chunks")
    ap.add_argument("--ckpt-every", type=int, default=8,
                    help="gate chunks between checkpoints")
    ap.add_argument("--restore", default=None, metavar="DIR",
                    help="restore the continuous engine from the newest "
                         "checkpoint under DIR onto the live ranks, drain "
                         "its in-flight requests, then serve the stream "
                         "(implies --continuous)")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="continuous mode: a result cache persisted under "
                         "DIR")
    ap.add_argument("--cache-max-bytes", type=int, default=256 << 20,
                    help="result-cache LRU payload budget")
    ap.add_argument("--warm-start", action="store_true",
                    help="continuous mode: a result cache (in memory "
                         "unless --cache-dir) seeding near-duplicates from "
                         "cached iterates")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    return ap.parse_args(argv)


def check_args(args: argparse.Namespace) -> None:
    """Raise on `--no-donate`; `--restore` implies `--continuous`, as in
    the reference."""
    if args.restore:
        args.continuous = True
    if args.no_donate:
        raise ValueError("--no-donate: the port's continuous engine updates "
                         "its slot state in place (the counterpart of the "
                         "reference's donated buffers), so there is no "
                         "donation to turn off")


def run(args: argparse.Namespace):
    """Serve the stream cold, then warm (and with a B = 1 engine unless
    --no-loop-compare), then with --continuous through the continuous
    engine, printing the reference's lines.  Returns {"engine", "specs",
    "results", "recs", "sweeps", "buckets", "stats_cold", "stats_warm",
    "cold", "warm", "loop_warm", "continuous"}; "continuous" is None or
    {"engine", "results", "ticks", "stream_s", "stats_warmup",
    "stats_stream"}.  The engines stay open (their graphs and buffers)
    for the caller to read and close.  On ranks (--nproc, torchrun) each
    rank closes its engines before it leaves the group, and this returns
    None."""
    check_args(args)
    # the reference's check: the mesh shape must use every device
    msc_mesh_shape("flat", world_size(args), parse_shape(args.mesh_shape))
    return on_ranks(args, _serve_here)


def _close(out) -> None:
    out["engine"].close()
    if out["continuous"] is not None:
        out["continuous"]["engine"].close()


def _serve_here(args: argparse.Namespace, dev):
    """`_serve` on `dev`; a rank closes its engines and returns None."""
    import torch.distributed as dist

    out = _serve(args, dev)
    if dist.is_available() and dist.is_initialized():
        _close(out)
        return None
    return out


def _serve(args: argparse.Namespace, dev) -> dict:
    """The serving run on `dev`: on a flat mesh of every rank when the
    process group is up (rank 0 prints), else on one device."""
    import torch.distributed as dist

    mesh, say = None, print
    if dist.is_available() and dist.is_initialized():
        mesh = make_msc_mesh("flat", parse_shape(args.mesh_shape), dev.type)
        if dist.get_rank() != 0:
            say = _silent
    sizes = [int(s) for s in args.sizes.split(",")]
    cfg = MSCConfig(epsilon=3e-4, power_tol=args.power_tol,
                    precision=args.precision, epilogue=args.epilogue)
    say(f"MSC serve: {args.requests} requests over sizes {sizes}, "
        f"mesh {mesh_dims(mesh) if mesh is not None else {'slice': 1}}, "
        f"B={args.max_batch}, "
        f"epilogue={args.epilogue} precision={args.precision} "
        f"device={dev}")
    specs, tensors = build_request_stream(sizes, args.requests, args.seed,
                                          slow_every=args.slow_every,
                                          device=dev)
    engine = MSCServeEngine(cfg, max_batch=args.max_batch,
                            bucket_quantum=args.bucket_quantum, device=dev,
                            mesh=mesh)
    buckets = sorted({engine.bucket_of(t.shape) for t in tensors})
    say(f"buckets: {buckets}")

    t0 = time.perf_counter()
    results = engine.run(tensors)  # cold: captures each bucket's graphs
    cold_s = time.perf_counter() - t0
    stats_cold = engine.stats
    t0 = time.perf_counter()
    engine.run(tensors)  # warm: replays only
    warm_s = time.perf_counter() - t0
    stats_warm = engine.stats.delta(stats_cold)

    recs, sweeps = [], []
    for i, (spec, res) in enumerate(zip(specs, results)):
        recs.append(float(recovery_rate(planted_masks(spec),
                                        [res[j].mask for j in range(3)])))
        sweeps.append([res[j].power_iters_run for j in range(3)])
        say(f"  req {i}: shape={spec.shape} rec={recs[-1]:.3f} "
            f"sizes={[res[j].size for j in range(3)]} sweeps={sweeps[-1]}")

    s = engine.stats
    say(f"stats: {s.dispatches} dispatches, {s.compiles} compiles, "
        f"{s.exec_cache_hits} exec cache hits, "
        f"{s.filler_slots} filler slots")
    say(f"cold {cold_s:.2f}s (incl. {s.compiles} compiles), "
        f"warm {warm_s:.2f}s "
        f"({args.requests / warm_s:.1f} req/s)")
    if dev.type == "cuda":
        static, pools = engine.memory_reckoning()
        say(f"graphs: {engine.graphs} held for {len(buckets)} buckets "
            f"({stats_cold.compiles} captured cold, "
            f"{stats_warm.compiles} warm); static buffers {static} B, "
            f"graph pools {pools} B")

    loop_s = None
    if not args.no_loop_compare:
        loop = MSCServeEngine(cfg, max_batch=1,
                              bucket_quantum=args.bucket_quantum, device=dev,
                              mesh=mesh)
        loop.run(tensors)  # capture its graphs
        t0 = time.perf_counter()
        loop.run(tensors)
        loop_s = time.perf_counter() - t0
        loop.close()
        say(f"looped (B=1) warm {loop_s:.2f}s → batched speedup "
            f"{loop_s / warm_s:.2f}x")
    out = {"engine": engine, "specs": specs, "results": results,
           "recs": recs, "sweeps": sweeps, "buckets": buckets,
           "stats_cold": stats_cold, "stats_warm": stats_warm,
           "cold": cold_s, "warm": warm_s, "loop_warm": loop_s,
           "continuous": None}
    if args.continuous:
        out["continuous"] = run_continuous(args, cfg, tensors, dev, mesh,
                                           say)
    return out


def _silent(*args, **kw) -> None:
    """The print of a rank other than 0."""


def run_continuous(args: argparse.Namespace, cfg: MSCConfig, tensors,
                   dev: torch.device, mesh=None, say=print) -> dict:
    """The stream through MSCContinuousEngine under Poisson arrivals,
    every bucket warmed off the clock first, with the reference's lines
    (on `mesh` when given): a new engine with the tier flags, or with
    --restore one restored from a checkpoint whose in-flight requests
    are drained first."""
    say(f"\ncontinuous decode loop: Poisson arrivals "
        f"{args.arrival_rate}/tick, slow-every={args.slow_every}")
    rcache = None
    if args.cache_dir or args.warm_start:
        rcache = MSCResultCache(max_bytes=args.cache_max_bytes,
                                persist_dir=args.cache_dir)
        if len(rcache):
            say(f"result cache: reloaded {len(rcache)} entr"
                f"{'y' if len(rcache) == 1 else 'ies'} "
                f"({rcache.nbytes >> 10} KiB) from {args.cache_dir}")
    if args.restore:
        from repro_torch.launch.elastic import (best_msc_shape,
                                                restore_msc_engine)

        ceng = restore_msc_engine(
            args.restore, device=dev, device_type=dev.type,
            checkpoint_dir=args.checkpoint_dir or args.restore,
            ckpt_every_chunks=args.ckpt_every, result_cache=rcache,
            warm_start=args.warm_start)
        drained = {}
        while ceng.has_work():
            drained.update(ceng.step())
        # one device: the reference's elastic mesh over one device
        shape = (mesh_dims(ceng.mesh) if ceng.mesh is not None
                 else dict(zip(("slice", "inner"), best_msc_shape(1))))
        say(f"restored from {args.restore} onto mesh {shape}; drained "
            f"{len(drained)} in-flight request(s)")
    else:
        ceng = MSCContinuousEngine(
            cfg, slots=args.slots or args.max_batch,
            bucket_quantum=args.bucket_quantum,
            chunks_per_step=(args.chunks_per_step
                             if args.chunks_per_step == "auto"
                             else int(args.chunks_per_step)),
            checkpoint_dir=args.checkpoint_dir,
            ckpt_every_chunks=args.ckpt_every, result_cache=rcache,
            warm_start=args.warm_start, autotune=args.autotune,
            preempt=not args.no_preempt,
            slo_chunks=args.slo_chunks, bucket_policy=args.bucket_policy,
            device=dev, mesh=mesh)
    probes = {}  # warm every bucket's programs off the clock
    for t in tensors:
        probes.setdefault(ceng.bucket_of(t.shape), t)
    ceng.run(list(probes.values()))
    base = ceng.stats
    mix = None
    if args.priority_mix:
        mix = {int(k): float(v) for k, v in
               (kv.split(":") for kv in args.priority_mix.split(","))}
        say(f"  priority mix: {mix} arrivals/tick per class")
    results, ticks, stream_s, shed = simulate_continuous(
        ceng, tensors, arrival_rate=args.arrival_rate, seed=args.seed,
        priority_rates=mix, deadline_chunks=args.deadline_chunks)
    cs = ceng.stats.delta(base)  # the stream only, not the warm-up
    say(f"streamed {len(results)} results over {ticks} ticks in "
        f"{stream_s:.2f}s ({len(results) / stream_s:.1f} req/s)")
    say(f"  occupancy {cs.occupancy:.2f} "
        f"({cs.busy_slot_chunks}/{cs.slot_chunks} slot-chunks), "
        f"{cs.evictions} evictions, {cs.refills} refills, "
        f"mean queue wait "
        f"{cs.queue_wait_chunks / max(cs.requests, 1):.2f} chunks")
    ss = ceng.stats  # cumulative (restores predate the base); p50/p99 rolling
    say(f"  scheduler: {ss.preemptions} preemptions, "
        f"{ss.resumes} resumes, {ss.deadline_misses} deadline "
        f"misses, {ss.slo_sheds} SLO-shed ({shed} dropped), "
        f"{ss.idle_bucket_ticks} idle-bucket ticks, queue wait "
        f"p50 {ss.queue_wait_p50_chunks:.1f} / "
        f"p99 {ss.queue_wait_p99_chunks:.1f} chunks")
    say(f"  fault tolerance: {ss.checkpoints_written} checkpoints, "
        f"{ss.restores} restores, {ss.retries} retries, "
        f"{ss.shed_requests} shed, "
        f"{ss.fallback_requests} fallback-served, "
        f"{ss.heartbeats_missed} heartbeats missed, "
        f"{ss.host_losses} host losses, {ss.reinits} reinits, "
        f"{ss.shard_files_written} shard files, "
        f"{ss.cache_hits} cache hits / {ss.cache_misses} misses, "
        f"{ss.warm_starts} warm starts "
        f"({ss.warm_sweeps_saved} sweeps saved)")
    if args.autotune:
        say(f"  autotune: {ss.autotune_searches} searches, "
            f"{ss.autotune_cache_hits} cache hits")
    if rcache is not None and args.cache_dir:
        if ceng._rank0():
            rcache.persist()
        say(f"  result cache persisted: {len(rcache)} entries, "
            f"{rcache.nbytes >> 10} KiB → {args.cache_dir}")
    if dev.type == "cuda":
        static, pools = ceng.memory_reckoning()
        say(f"  graphs: {ceng.graphs} held for {len(probes)} buckets "
            f"({base.compiles} captured warming up, {cs.compiles} in "
            f"the stream); static buffers {static} B, graph pools "
            f"{pools} B")
    for i in (0, len(tensors) - 1):
        if i in results:  # a shed request has no result
            sw = [results[i][j].power_iters_run for j in range(3)]
            say(f"  req {i}: sweeps={sw}")
    return {"engine": ceng, "results": results, "ticks": ticks,
            "stream_s": stream_s, "stats_warmup": base,
            "stats_stream": cs, "shed": shed, "cache": rcache}


def main(argv=None) -> int:
    out = run(parse_args(argv))
    if out is not None:
        _close(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
