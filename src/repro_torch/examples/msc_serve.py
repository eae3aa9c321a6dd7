"""Batched MSC serving example: a 3-bucket request stream end to end —
counterpart of `examples/msc_serve.py`.

Many independent MSC requests of assorted sizes.  `MSCServeEngine`
rounds each request's dims up to a shape bucket, packs each bucket into
fixed-size microbatches and runs every microbatch through the bucket's
captured programs (CUDA graphs on a card): after the first request of a
bucket, serving captures nothing more.

The second part streams requests of the same buckets through the
continuous-batching `MSCContinuousEngine` under Poisson arrivals with
mixed convergence difficulty (a few near-noise slow convergers among
fast high-γ requests) and prints the decode loop's occupancy, eviction
and queue-wait counters; the third mixes priority classes (the SLO
scheduler, preempt-to-host); the last fronts the continuous engine with
the two-tier result cache on a repeat-heavy mix: exact repeats are
answered without the device, near-duplicates warm-start from the
cached iterates.  On a mesh of ranks the engines run through
`launch/msc_serve.py --mesh-shape`.

  PYTHONPATH=src python -m repro_torch.examples.msc_serve
  PYTHONPATH=src python -m repro_torch.examples.msc_serve --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (MSCConfig, PlantedSpec, make_planted_tensor,
                              planted_masks, recovery_rate, resolve_device)
from repro_torch.launch.msc_serve import simulate_continuous
from repro_torch.serving import (MSCContinuousEngine, MSCResultCache,
                                 MSCServeEngine)


def _planted(seed: int, spec: PlantedSpec, dev) -> torch.Tensor:
    return make_planted_tensor(torch.Generator(device=dev).manual_seed(seed),
                               spec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--arrival-rate", type=float, default=1.5,
                    help="mean Poisson arrivals per scheduler tick in the "
                         "continuous stream")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # a stream over three buckets (quantum 8 → 16³ / 24³ / 40³), the
    # non-cube requests landing in the cube buckets through padding
    specs = [
        PlantedSpec.paper(14, 70.0),
        PlantedSpec.paper(21, 70.0),
        PlantedSpec(shape=(21, 24, 18), cluster_sizes=(2, 3, 2), gamma=60.0),
        PlantedSpec.paper(33, 70.0),
        PlantedSpec.paper(16, 70.0),
        PlantedSpec.paper(24, 40.0),
        PlantedSpec(shape=(38, 33, 39), cluster_sizes=(4, 3, 4), gamma=70.0),
        PlantedSpec.paper(21, 90.0),
    ]
    tensors = [_planted(i, s, dev) for i, s in enumerate(specs)]
    cfg = MSCConfig(epsilon=3e-4)
    engine = MSCServeEngine(cfg, max_batch=args.max_batch, device=dev)

    buckets = {}
    for t in tensors:
        buckets.setdefault(engine.bucket_of(t.shape), []).append(
            tuple(t.shape))
    print(f"mesh {{'slice': 1}}; {len(tensors)} requests → "
          f"{len(buckets)} buckets:")
    for b, shapes in sorted(buckets.items()):
        print(f"  {b}: {shapes}")

    t0 = time.perf_counter()
    results = engine.run(tensors)  # cold: each bucket's programs built
    print(f"\ncold pass {time.perf_counter() - t0:.2f}s "
          f"({engine.stats.compiles} executables compiled)")
    t0 = time.perf_counter()
    results = engine.run(tensors)  # warm: replays only
    warm = time.perf_counter() - t0
    s = engine.stats
    print(f"warm pass {warm:.2f}s — {s.exec_cache_hits} exec cache hits, "
          f"{s.compiles} total compiles (none new), "
          f"{s.filler_slots} filler slots\n")
    for spec, res in zip(specs, results):
        rec = float(recovery_rate(planted_masks(spec),
                                  [res[j].mask for j in range(3)]))
        print(f"  {str(spec.shape):14s} rec={rec:.3f} "
              f"sweeps={[int(res[j].power_iters_run) for j in range(3)]}")
    engine.close()

    # ---- the continuous decode loop under Poisson arrivals -------------
    # every 4th request near-noise (γ = 2, 10–20x the sweeps): the skewed
    # mix where static microbatching holds B − 1 slots on the slowest
    stream_specs = [PlantedSpec.paper((14, 21, 16, 24)[i % 4],
                                      2.0 if i % 4 == 0 else 120.0)
                    for i in range(12)]
    stream = [_planted(100 + i, s, dev) for i, s in enumerate(stream_specs)]
    ccfg = cfg.with_(power_tol=1e-2)
    ceng = MSCContinuousEngine(ccfg, slots=args.max_batch, device=dev)
    probes = {}
    for t in stream:
        probes.setdefault(ceng.bucket_of(t.shape), t)
    ceng.run(list(probes.values()))  # each bucket's two programs, warm
    base = ceng.stats
    print(f"\ncontinuous stream: {len(stream)} requests, Poisson "
          f"{args.arrival_rate}/tick, slots={args.max_batch}")
    results, ticks, stream_s, _ = simulate_continuous(
        ceng, stream, arrival_rate=args.arrival_rate, seed=7)
    s = ceng.stats.delta(base)  # the stream only, not the warm-up
    print(f"drained in {ticks} ticks / {stream_s:.2f}s "
          f"({len(results) / stream_s:.1f} req/s)")
    print(f"occupancy {s.occupancy:.2f} "
          f"({s.busy_slot_chunks}/{s.slot_chunks} slot-chunks), "
          f"{s.evictions} evictions over {s.refills} refills, "
          f"mean queue wait "
          f"{s.queue_wait_chunks / max(s.requests, 1):.2f} chunks")
    for i, spec in enumerate(stream_specs):
        sw = [int(results[i][j].power_iters_run) for j in range(3)]
        kind = "slow" if i % 4 == 0 else "fast"
        print(f"  req {i:2d} {str(spec.shape):14s} {kind} sweeps={sw}")
    ceng.close()

    # ---- mixed priorities and preempt-to-host --------------------------
    # interactive (class 0) requests racing near-noise batch (class 1)
    # work: a batch slot may be parked on the host for an interactive
    # request and resumed later through the same refill, bit for bit
    sched_specs = [PlantedSpec.paper(16, 2.0 if i % 3 == 0 else 150.0)
                   for i in range(9)]
    sched_stream = [_planted(300 + i, s, dev)
                    for i, s in enumerate(sched_specs)]
    seng = MSCContinuousEngine(ccfg, slots=max(2, args.max_batch // 2),
                               preempt_min_remaining_chunks=1, device=dev)
    seng.run(sched_stream[:3])  # warm programs and the sweep histogram
    base = seng.stats
    print(f"\nmixed-priority stream: {len(sched_stream)} requests "
          f"(every 3rd near-noise → class 1, rest class 0)")
    got = {}
    rids = [seng.submit(t, priority=1 if i % 3 == 0 else 0,
                        deadline_chunks=64)
            for i, t in enumerate(sched_stream)]
    while seng.has_work():
        got.update(seng.step())
    s = seng.stats.delta(base)
    print(f"scheduler: {s.preemptions} preemptions, {s.resumes} resumes, "
          f"{s.deadline_misses} deadline misses; queue wait "
          f"p50 {seng.stats.queue_wait_p50_chunks:.1f} / "
          f"p99 {seng.stats.queue_wait_p99_chunks:.1f} chunks")
    for i, rid in enumerate(rids):
        sw = [int(got[rid][j].power_iters_run) for j in range(3)]
        print(f"  req {i:2d} class {1 if i % 3 == 0 else 0} sweeps={sw}")
    seng.close()

    # ---- the result cache: repeats and near-duplicates -----------------
    rng = np.random.RandomState(42)
    # slow convergers (γ = 2, near-noise): the requests worth caching
    pool = [_planted(200 + i, PlantedSpec.paper(16, 2.0), dev).cpu()
            .numpy().astype(np.float32) for i in range(3)]
    mix = []
    for i in range(9):
        base_t = pool[i % len(pool)]
        if i % 3 == 2:  # near-duplicate: ~0.3% relative perturbation
            noise = rng.standard_normal(base_t.shape).astype(np.float32)
            mix.append(("near", base_t + 0.003 * base_t.std() * noise))
        else:  # exact repeat, in another memory layout
            mix.append(("exact", np.asfortranarray(base_t)))
    cache = MSCResultCache(max_bytes=64 << 20)
    keng = MSCContinuousEngine(ccfg, slots=args.max_batch, result_cache=cache,
                               warm_start=True, device=dev)
    cold_results = keng.run(pool)  # cold: solves, and seeds the cache
    base_stats = keng.stats
    t0 = time.perf_counter()
    mix_results = keng.run([t for _, t in mix])
    mix_s = time.perf_counter() - t0
    s = keng.stats.delta(base_stats)
    print(f"\nresult-cache mix: {len(mix)} requests in {mix_s:.2f}s — "
          f"{s.cache_hits} exact hits, {s.warm_starts} warm starts, "
          f"{s.cache_misses} misses ({s.dispatches} device dispatches)")
    print(f"  cache: {len(cache)} entries, {cache.nbytes >> 10} KiB, "
          f"{s.warm_sweeps_saved} sweeps saved by warm starts")
    for res in cold_results:
        print(f"  cold  sweeps={[int(res[j].power_iters_run) for j in range(3)]}")
    for (kind, _), res in zip(mix, mix_results):
        print(f"  {kind:5s} sweeps="
              f"{[int(res[j].power_iters_run) for j in range(3)]}")
    keng.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
