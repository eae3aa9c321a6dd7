"""Roofline models — counterpart of `repro/roofline/analyze.py`.

Analytic models of the MSC schedules (the similarity epilogue, the 2-D
sharded eigensolve, the inter-mode relayout, static and continuous
serving) and the "auto" choosers that read them: `choose_relayout`,
`choose_epilogue` and `choose_chunk_steps`.  Every model takes `hw=`,
the reference's `V5E` by default, so a call without it gives the
reference's numbers; the port's call sites pass
`hw.target_hw(device)` (`H100` on a card).  Also the LM side's model
FLOPs (`model_flops`, `active_param_count`, the dense families the port
builds) and the `RooflineReport` record with `save_report`.

The reference builds a report from an XLA compiled object
(`report_from_compiled`, through its HLO parser); the port's profile-based
counterpart comes with `launch/dryrun.py` (ROADMAP.md queue 1 item 12).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List

from .hw import V5E, HwSpec


def active_param_count(cfg) -> float:
    """Non-embedding *active* parameter count, analytic from the config."""
    from repro_torch.models import count_params, model_defs

    n_total = count_params(model_defs(cfg))
    n_active = float(n_total) - cfg.vocab_size * cfg.d_model  # embed gather
    if cfg.tie_embeddings:
        n_active += cfg.vocab_size * cfg.d_model  # reused as lm_head matmul
    if cfg.n_experts and cfg.experts_per_token:
        inactive = cfg.n_experts - cfg.experts_per_token
        per_layer = 3 * inactive * cfg.d_model * cfg.d_expert
        n_active -= cfg.n_layers * per_layer
    return n_active


def model_flops(cfg, shape, kind: str) -> float:
    """6·N_active·D for training, 2·N_active·D forward-only."""
    n_act = active_param_count(cfg)
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_act * tokens
    # decode: one token per sequence
    return 2.0 * n_act * shape.global_batch


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float          # assignment formula (operand bytes)
    collective_link_s: float     # ring model per-link bytes
    dominant: str
    model_flops: float
    hlo_flops_global: float
    flops_ratio: float           # MODEL_FLOPS / HLO_FLOPs
    bytes_per_device: float
    collective_bytes_global: float
    collectives_by_kind: Dict
    unknown_trip_counts: int
    xla_cost_analysis: Dict
    memory_stats: Dict
    note: str = ""

    @property
    def bound_s(self) -> float:
        """No-overlap step-time lower bound."""
        return max(self.compute_s, self.memory_s, self.collective_link_s)

    @property
    def roofline_fraction(self) -> float:
        """compute_s / bound_s: 1.0 ⇔ the cell is compute-bound (at the
        roofline); < 1 ⇔ memory or collectives dominate."""
        b = self.bound_s
        return self.compute_s / b if b > 0 else 0.0

    @property
    def mfu_bound(self) -> float:
        """Upper bound on MFU: useful model FLOPs over peak×bound time."""
        denom = self.chips * V5E.peak_flops_bf16 * self.bound_s
        return self.model_flops / denom if denom > 0 else 0.0

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["bound_s"] = self.bound_s
        d["roofline_fraction"] = self.roofline_fraction
        d["mfu_bound"] = self.mfu_bound
        return d

    def summary(self) -> str:
        return (f"{self.arch:22s} {self.shape:12s} {self.mesh:10s} "
                f"comp={self.compute_s*1e3:9.3f}ms "
                f"mem={self.memory_s*1e3:9.3f}ms "
                f"coll={self.collective_link_s*1e3:9.3f}ms "
                f"dom={self.dominant:10s} "
                f"ratio={self.flops_ratio:6.3f} "
                f"roofline={self.roofline_fraction:5.1%}")


def epilogue_model(m: int, c: int, p: int, *, epilogue: str = "allgather",
                   dtype_bytes: float = 4.0, hw: HwSpec = V5E) -> Dict:
    """Analytic comm/compute/memory model of the MSC similarity epilogue.

    Models the Alg. 2 epilogue (d = row-sums of |V Vᵀ|, V ∈ R^{m×c})
    per device on a p-device ring, for both MSCConfig.epilogue policies
    (DESIGN.md §7.4).  Both move the same per-link bytes —
    (p−1)/p · m·c·B — but differ in peak buffer and overlap:

      allgather: one blocking all_gather replicates V (peak buffer
        m·c·B), then the row-block matmul runs — latency is the *sum*
        comm_s + compute_s.
      ring: p−1 ppermute steps of one (m/p)×c chunk each (peak buffer
        chunk_bytes); each transfer is hidden under the concurrent chunk
        matmul — latency ≈ first chunk's compute + (p−1)·max(step comm,
        step compute).

    m is padded to even shards exactly like the schedules pad it, so the
    predicted bytes match the compiled collectives (fig8 / BENCH_ring_
    epilogue contract: within 10%).  Returns a dict of link_bytes,
    peak_buffer_bytes, comm_s, compute_s, latency_s (plus the inputs).
    """
    if epilogue not in ("allgather", "ring"):
        raise ValueError(f"unknown epilogue {epilogue!r}")
    m_pad = ((m + p - 1) // p) * p
    rows = m_pad // p
    chunk_bytes = rows * c * dtype_bytes
    full_bytes = m_pad * c * dtype_bytes
    # per-device epilogue matmul: (m/p) × c rows against all m_pad rows
    flops = 2.0 * rows * m_pad * c
    compute_s = flops / hw.peak_flops_bf16
    link_bytes = (p - 1) * chunk_bytes  # == full_bytes * (p-1)/p, both
    comm_s = link_bytes / hw.ici_bw
    if epilogue == "allgather":
        peak_buffer = full_bytes
        latency_s = comm_s + compute_s
    else:
        peak_buffer = chunk_bytes
        step_comm = chunk_bytes / hw.ici_bw
        step_compute = compute_s / p
        latency_s = step_compute + (p - 1) * max(step_comm, step_compute)
    return {
        "epilogue": epilogue, "m": m, "c": c, "p": p,
        "dtype_bytes": dtype_bytes,
        "link_bytes": link_bytes, "peak_buffer_bytes": peak_buffer,
        "chunk_bytes": chunk_bytes, "flops": flops,
        "comm_s": comm_s, "compute_s": compute_s, "latency_s": latency_s,
    }


def eigensolve_model(m: int, r: int, c: int, p: int, q: int = 1, *,
                     sweeps: int = 12, dtype_bytes: float = 4.0,
                     overlap: bool = False, hw: HwSpec = V5E) -> Dict:
    """Analytic memory/comm/compute model of the 2-D sharded eigensolve.

    Models the matrix-free power iteration on a ("slice"=p, "inner"=q)
    mesh (DESIGN.md §7.5): each device holds a (m/p, r/q, c) block of
    the slice-major tensor and every sweep computes a partial
    w = Tᵀ(T v) over its local rows, followed by one lax.psum of the
    (m/p, c) fp32 partial over the q inner devices.

      block_bytes_per_device = m/p · r/q · c · B  — the dominant
        eigensolve buffer; growing q at fixed p shrinks it q× (the
        BENCH_inner_shard acceptance bar).
      psum_link_bytes = sweeps · 2(q−1)/q · (m/p)·c·4  — the extra
        inner-axis reduce bytes per device (ring all-reduce of the fp32
        accumulator; zero when q = 1, i.e. the 1-D schedules).
      compute_s = sweeps · 4·(m/p)·(r/q)·c / peak — the two matvec
        halves; the psum is a sync point inside each sweep (v must be
        complete before normalization), so the no-overlap latency is
        sweeps · (step_compute + step_comm).

    overlap=True models the double-buffered inner psum (DESIGN.md
    §7.11, `matvec_matrix_free(overlap=True)`): the slice batch splits
    in half, so half B's local contractions hide half A's reduction —
    per sweep, latency drops from (compute + comm) to
    compute/2 + max(compute/2, comm/2) + comm/2 (the second half's
    psum stays exposed: normalization needs the complete w).  No-op at
    q = 1, exactly like the implementation.

    Dims are padded to even shards exactly like ModeSchedule pads them.
    """
    m_pad = ((m + p - 1) // p) * p
    r_pad = ((r + q - 1) // q) * q
    b_loc, r_loc = m_pad // p, r_pad // q
    block_bytes = b_loc * r_loc * c * dtype_bytes
    w_bytes = b_loc * c * 4.0  # fp32 partial accumulator
    step_link = 2.0 * (q - 1) / q * w_bytes if q > 1 else 0.0
    step_flops = 4.0 * b_loc * r_loc * c
    step_compute = step_flops / hw.peak_flops_bf16
    step_comm = step_link / hw.ici_bw
    if overlap and q > 1:
        step_latency = (step_compute / 2.0
                        + max(step_compute / 2.0, step_comm / 2.0)
                        + step_comm / 2.0)
    else:
        step_latency = step_compute + step_comm
    return {
        "m": m, "r": r, "c": c, "p": p, "q": q, "sweeps": sweeps,
        "dtype_bytes": dtype_bytes, "overlap": bool(overlap and q > 1),
        "block_bytes_per_device": block_bytes,
        "w_partial_bytes": w_bytes,
        "psum_link_bytes": sweeps * step_link,
        "flops": sweeps * step_flops,
        "comm_s": sweeps * step_comm,
        "compute_s": sweeps * step_compute,
        "latency_s": sweeps * step_latency,
    }


RELAYOUTS = ("gspmd", "collective", "collective_stream")


def relayout_model(shape, p: int, q: int = 1, *, B: int = 1,
                   sweeps: int = 12, dtype_bytes: float = 4.0,
                   launch_s: float = 1e-6, hw: HwSpec = V5E) -> Dict:
    """Analytic model of the flat schedule's inter-mode relayout
    (DESIGN.md §7.11) — the decision surface of `choose_relayout`.

    The collective relayout moves the whole local block twice over the
    slice axis (modes 2 and 3; plus once over the inner axis at q > 1),
    each all_to_all sending L·(p−1)/p bytes per device where L is the
    padded local block (`_build_flat_collective` pads each dim to its
    split multiple).  Three schedules:

      gspmd — the partitioner's reshard: same link bytes, no explicit
        collective launches (the reshard fuses), but the measured
        replicate-then-slice fallback materializes the block once
        (§Perf msc it 2): + 2·L/hbm_bw per relayout.
      collective — explicit tiled all_to_all per relayout: exact link
        bytes, one launch each, but the a2a is a single blocking
        collective: every downstream mode waits for the full payload.
        Total = comm + all three modes' eigensolve compute, serial.
      collective_stream — the a2a decomposed into p−1 ppermute chunk
        steps (`_stream_all_to_all`, the ring-epilogue pattern):
        mode j+1's chunks stream while mode j's eigensolve runs, so
        per relayout only max(0, comm − prev_mode_compute) plus one
        chunk's fill is exposed.  p−1 launches per relayout.

    Per-sweep compute takes the HBM floor max(flops/peak, L/hbm_bw) —
    at serving sizes the block re-read dominates the matvec flops.
    `sweeps` feeds from measured sweep histograms (the engine passes
    the observed per-bucket median, not a guess).  Returns latencies
    for all three plus `overlap_speedup` = blocking/streamed — the
    BENCH_msc_autotune acceptance quantity.
    """
    m1, m2, m3 = (int(s) for s in shape)
    g = math.gcd(p, q)
    m1p = -(-m1 // (p * q)) * (p * q)
    m2p = -(-m2 // (p * q // g)) * (p * q // g)
    m3p = -(-m3 // p) * p
    L = float(B) * m1p * m2p * m3p * dtype_bytes / (p * q)
    a2a_bytes = L * (p - 1) / p          # per slice-axis all_to_all
    inner_bytes = L * (q - 1) / q if q > 1 else 0.0
    comm_a2a_s = a2a_bytes / hw.ici_bw
    comm_inner_s = inner_bytes / hw.ici_bw
    link_bytes = 2 * a2a_bytes + inner_bytes

    # per-mode eigensolve compute with the HBM floor (B·m/p·r/q·c block
    # re-read per sweep)
    mode_dims = ((m1p, m2p, m3p), (m2p, m1p, m3p), (m3p, m1p, m2p))
    mode_compute = []
    for m, r, c in mode_dims:
        flops = 4.0 * B * (m // p) * (-(-r // q)) * c
        sweep_s = max(flops / hw.peak_flops_bf16, L / hw.hbm_bw)
        mode_compute.append(sweeps * sweep_s)
    compute_s = sum(mode_compute)

    # gspmd: fused reshard, no explicit launches, + materialization
    n_relayouts = 2 + (1 if q > 1 else 0)
    remat_s = 2.0 * L / hw.hbm_bw
    gspmd_s = (compute_s + 2 * comm_a2a_s + comm_inner_s
               + n_relayouts * remat_s)
    # collective: blocking a2a, one launch each, fully serialized
    blocking_s = (compute_s + 2 * comm_a2a_s + comm_inner_s
                  + n_relayouts * launch_s)
    # collective_stream: mode j+1's relayout hides under mode j's solve
    fill_s = comm_a2a_s / max(p - 1, 1)
    exposed2 = max(0.0, comm_a2a_s - mode_compute[0])
    exposed3 = max(0.0, comm_a2a_s - mode_compute[1])
    stream_launch = (p - 1) * 2 * launch_s + \
        ((q - 1) * launch_s if q > 1 else 0.0)
    streamed_s = (compute_s + comm_inner_s + exposed2 + exposed3
                  + 2 * fill_s + stream_launch)
    return {
        "shape": (m1, m2, m3), "p": p, "q": q, "B": B, "sweeps": sweeps,
        "dtype_bytes": dtype_bytes, "launch_s": launch_s,
        "local_block_bytes": L, "link_bytes": link_bytes,
        "a2a_bytes": a2a_bytes, "comm_s": 2 * comm_a2a_s + comm_inner_s,
        "compute_s": compute_s,
        "gspmd_s": gspmd_s, "collective_s": blocking_s,
        "collective_stream_s": streamed_s,
        "overlap_speedup": (blocking_s / streamed_s
                            if streamed_s > 0 else 0.0),
    }


def choose_relayout(shape, p: int, q: int = 1, *, B: int = 1,
                    sweeps: int = 12, dtype_bytes: float = 4.0,
                    launch_s: float = 1e-6, hw: HwSpec = V5E) -> str:
    """Pick the flat schedule's relayout from `relayout_model`:
    the latency argmin over ("gspmd", "collective", "collective_stream"),
    first-listed wins ties (stability: a degenerate p=1 mesh, where all
    three collapse to zero comm, keeps the partitioner default)."""
    if p <= 1:
        return "gspmd"
    m = relayout_model(shape, p, q, B=B, sweeps=sweeps,
                       dtype_bytes=dtype_bytes, launch_s=launch_s, hw=hw)
    lat = {"gspmd": m["gspmd_s"], "collective": m["collective_s"],
           "collective_stream": m["collective_stream_s"]}
    return min(RELAYOUTS, key=lambda k: (lat[k],))


def choose_epilogue(m: int, c: int, p: int, *, dtype_bytes: float = 4.0,
                    hw: HwSpec = V5E) -> str:
    """Pick the similarity epilogue from `epilogue_model`: ring when its
    overlapped latency beats the blocking all_gather, allgather on ties
    (one collective, simpler schedule) and always at p = 1."""
    if p <= 1:
        return "allgather"
    ag = epilogue_model(m, c, p, epilogue="allgather",
                        dtype_bytes=dtype_bytes, hw=hw)["latency_s"]
    ring = epilogue_model(m, c, p, epilogue="ring",
                          dtype_bytes=dtype_bytes, hw=hw)["latency_s"]
    return "ring" if ring < ag else "allgather"


def choose_chunk_steps(iter_hist, B: int, *, check_every: int = 6,
                       candidates=(1, 2, 4), shape=None, p: int = 1,
                       q: int = 1, epilogue: str = "allgather",
                       dispatch_s: float = 0.0,
                       dtype_bytes: float = 4.0, hw: HwSpec = V5E) -> int:
    """Pick the continuous engine's chunks_per_step from the measured
    sweep histogram: run `continuous_serving_model` once per candidate
    (chunks_per_step=s coarsens the scheduler tick to s·check_every
    sweeps per dispatch — fewer dispatches, coarser eviction) and take
    the wall-time argmin; smallest candidate wins ties (finest eviction
    granularity at equal predicted cost)."""
    best, best_s = None, None
    for s in sorted(int(c) for c in candidates):
        if s < 1:
            continue
        r = continuous_serving_model(
            iter_hist, B, check_every=check_every * s, shape=shape,
            p=p, q=q, epilogue=epilogue, dispatch_s=dispatch_s,
            dtype_bytes=dtype_bytes, hw=hw)
        if best_s is None or r["continuous_s"] < best_s:
            best, best_s = s, r["continuous_s"]
    if best is None:
        raise ValueError(f"no valid chunk-step candidates in {candidates}")
    return best


def expected_queue_wait(queued_ahead: int, free_slots: int, B: int,
                        chunks_per_request: float) -> float:
    """Predicted queue wait, in gate chunks, for a request joining a
    B-slot continuous table behind `queued_ahead` requests that will be
    served before it (its own class and more urgent ones), with
    `free_slots` slots currently free (DESIGN.md §7.12).

    The closed-form skeleton of the admission-control model: if the
    free slots cover everyone ahead plus this request it waits 0;
    otherwise each of the B slots frees once per `chunks_per_request`
    chunks on average, so the backlog drains at B/chunks_per_request
    requests per chunk and position (queued_ahead − free_slots + 1)
    waits proportionally.  `MSCContinuousEngine` feeds it the measured
    mean residency from its sweep histogram; `continuous_serving_model`
    exposes the full-distribution (p50/p99) version via simulation."""
    if B < 1:
        raise ValueError(f"B must be >= 1, got {B}")
    if queued_ahead < free_slots:
        return 0.0
    return ((queued_ahead - free_slots + 1)
            * max(1.0, float(chunks_per_request)) / B)


def continuous_serving_model(iter_hist, B: int, *, check_every: int = 6,
                             shape=None, p: int = 1, q: int = 1,
                             epilogue: str = "allgather",
                             dispatch_s: float = 0.0,
                             refill_min_free: int = 1,
                             dtype_bytes: float = 4.0,
                             exact_hit_rate: float = 0.0,
                             warm_hit_rate: float = 0.0,
                             warm_sweeps=None, lookup_s: float = 0.0,
                             arrivals=None, priorities=None,
                             aging_chunks: int = 16,
                             slo_chunks=None,
                             hw: HwSpec = V5E) -> Dict:
    """Predict continuous-vs-static occupancy from a per-request
    iteration histogram (DESIGN.md §7.7).

    iter_hist: realized power-iteration sweeps per request, in arrival
    order — the quantity the static engine's batch-max lockstep rounds
    every slot up to, and exactly what `ModeResult.power_iters_run`
    reports, so a measured serve can be replayed through this model.

    Both disciplines are simulated over the same sequence:

      static — microbatches of B in arrival order; every mode of every
        slot runs the batch max (rounded up to the gate-chunk size k),
        one dispatch per batch.
      continuous — a B-slot table advancing one k-sweep chunk per tick,
        all three modes concurrently; a finished slot is evicted at the
        next tick's refill dispatch (which also finalizes its results
        and admits from the queue under refill_min_free batching).

    Occupancy counts a slot·chunk as useful when the slot holds an
    unfinished request; the continuous scheduler exists to push this
    toward 1 where static lockstep decays as the skew grows.  With
    `shape` given, wall times come from `eigensolve_model` +
    `epilogue_model`: a chunk tick costs k eigensolve sweeps per mode,
    and the link-bound similarity epilogue is charged once per REFILL
    tick (finalize-on-evict — the reason the epilogue lives in the
    refill executable, not the chunk step: charged per chunk it would
    hand back most of the occupancy win at paper scale, where the
    epilogue is ICI-bound while a single sweep is not).  Without
    `shape`, a sweep costs 1 unit and `dispatch_s` is in the same
    units.  Returns occupancies, wall estimates, and speedup =
    static_s / continuous_s.

    Result-cache terms (DESIGN.md §7.10): `exact_hit_rate` removes that
    fraction of requests from the device stream entirely (tier-1 exact
    hits — they cost only `lookup_s` each), and `warm_hit_rate` clamps
    that fraction of the REMAINING requests' sweeps to `warm_sweeps`
    (default: one gate chunk, k — tier-2 warm starts converge at their
    first probe in the measured regime), reshaping the histogram the
    slot-table simulation runs over.  Hit requests are spread evenly
    across the arrival order (deterministic, so a replayed measurement
    is reproducible).  `lookup_s` charges every request one cache probe.
    Outputs gain `nocache_continuous_s` (the same simulation on the
    unreshaped histogram) and `cache_speedup` — the throughput factor
    the cache itself buys on top of continuous batching.  All existing
    outputs are unchanged when both rates are 0.

    Queue-wait terms (DESIGN.md §7.12): `arrivals` (per-request arrival
    tick, chunks, arrival order — default all 0) and `priorities`
    (per-request class, 0 most urgent — default all 0) drive a second
    slot-table simulation that mirrors the engine's weighted-aging
    admission (`aging_chunks`) with per-chunk admission (min_free=1 —
    the wait model, not the dispatch-batching model) and reports the
    realized wait distribution: `wait_p50_chunks` / `wait_p99_chunks`
    over all requests and `wait_by_class` ({class: {p50, p99, mean,
    n}}).  With `slo_chunks` set, requests whose `expected_queue_wait`
    at arrival exceeds the bound are shed on arrival (counted in
    `shed`, excluded from the wait percentiles) — the admission-control
    policy the engine applies live.
    """
    sweeps = [int(s) for s in iter_hist]
    if not sweeps or B < 1:
        raise ValueError("iter_hist must be non-empty and B >= 1")
    if not (0.0 <= exact_hit_rate <= 1.0 and 0.0 <= warm_hit_rate <= 1.0
            and exact_hit_rate + warm_hit_rate <= 1.0):
        raise ValueError(
            f"hit rates must lie in [0, 1] and sum to <= 1, got "
            f"exact={exact_hit_rate} warm={warm_hit_rate}")
    k = max(1, int(check_every))
    chunks_of = [max(1, -(-s // k)) for s in sweeps]  # ceil, >=1

    # ---- result-cache histogram reshaping ----
    n = len(sweeps)
    w_sweeps = k if warm_sweeps is None else max(1, int(warm_sweeps))

    def _spread(num: int, total: int):
        """num evenly-spaced indices in range(total) (num <= total:
        floor(i·(total−1)/(num−1)) is strictly increasing)."""
        if num <= 0:
            return []
        if num >= total:
            return list(range(total))
        if num == 1:
            return [0]
        return [(i * (total - 1)) // (num - 1) for i in range(num)]

    n_exact = int(round(exact_hit_rate * n))
    exact_idx = set(_spread(n_exact, n))
    rest = [i for i in range(n) if i not in exact_idx]
    n_warm = min(int(round(warm_hit_rate * n)), len(rest))
    warm_idx = {rest[j] for j in _spread(n_warm, len(rest))}
    dev_sweeps = [min(s, w_sweeps) if i in warm_idx else s
                  for i, s in enumerate(sweeps) if i not in exact_idx]
    dev_chunks_of = [max(1, -(-s // k)) for s in dev_sweeps]

    # per-mode per-sweep and per-epilogue wall costs
    if shape is not None:
        m1, m2, m3 = shape
        eig1, epi = [], []
        for m, r, c in ((m1, m2, m3), (m2, m1, m3), (m3, m1, m2)):
            eig1.append(eigensolve_model(m, r, c, p, q, sweeps=1,
                                         dtype_bytes=dtype_bytes,
                                         hw=hw)["latency_s"])
            epi.append(epilogue_model(m, c, p, epilogue=epilogue,
                                      dtype_bytes=dtype_bytes,
                                      hw=hw)["latency_s"])
    else:
        eig1, epi = [1.0] * 3, [0.0] * 3

    # static: batch-max lockstep per microbatch, modes sequential
    static_s, static_batches = 0.0, 0
    useful = sum(c * k for c in chunks_of)  # per mode, slot·sweeps
    static_slot_sweeps = 0
    for i in range(0, len(sweeps), B):
        batch = chunks_of[i:i + B]
        lock = max(batch) * k
        static_slot_sweeps += lock * B
        static_s += dispatch_s + sum(lock * e1 + ep
                                     for e1, ep in zip(eig1, epi))
        static_batches += 1
    occupancy_static = useful / static_slot_sweeps

    # continuous: slot-table simulation, modes concurrent per chunk,
    # eviction (and its finalize) at the tick after a slot finishes
    # a threshold no drain can reach would deadlock admission (the
    # engine clamps identically)
    min_free = min(max(1, int(refill_min_free)), B)

    def _simulate(stream):
        slots = [0] * B    # remaining chunks per slot (0 = free)
        queue = list(stream)
        chunks = refills = busy_slot_chunks = 0
        freed_now = 0
        while queue or any(slots) or freed_now:
            free = [s for s, r in enumerate(slots) if r == 0]
            admitted = False
            if queue and free and len(free) >= min(min_free, len(queue)):
                for s in free:
                    if not queue:
                        break
                    slots[s] = queue.pop(0)
                    admitted = True
            refills += int(freed_now > 0 or admitted)
            live = sum(r > 0 for r in slots)
            if live == 0:
                break  # the drain tick: evict/finalize only, no chunk
            busy_slot_chunks += live
            chunks += 1
            freed_now = sum(r == 1 for r in slots)  # evicted next tick
            slots = [max(0, r - 1) for r in slots]
        return chunks, refills, busy_slot_chunks

    chunks, refills, busy_slot_chunks = _simulate(dev_chunks_of)
    useful_dev = sum(c * k for c in dev_chunks_of)
    occupancy_continuous = (useful_dev / (chunks * B * k)
                            if chunks else 1.0)
    chunk_s = dispatch_s + sum(k * e1 for e1 in eig1)
    refill_s = dispatch_s + sum(epi)
    continuous_s = (chunks * chunk_s + refills * refill_s
                    + n * float(lookup_s))
    if n_exact or n_warm:
        c0, r0, _ = _simulate(chunks_of)
        nocache_continuous_s = c0 * chunk_s + r0 * refill_s
    else:
        nocache_continuous_s = chunks * chunk_s + refills * refill_s

    # ---- queue-wait simulation (DESIGN.md §7.12) ----
    arr = ([0] * n if arrivals is None
           else [int(a) for a in arrivals])
    pri = ([0] * n if priorities is None
           else [int(c) for c in priorities])
    if len(arr) != n or len(pri) != n:
        raise ValueError("arrivals/priorities must match iter_hist")
    aging = max(1, int(aging_chunks))
    mean_chunks = sum(chunks_of) / n
    queues: Dict[int, List] = {}   # class -> [(arrival, idx), ...]
    slots_w = [0] * B
    waits: List[tuple] = []        # (class, wait)
    shed = 0
    order = sorted(range(n), key=lambda i: arr[i])
    nxt, tick = 0, 0
    while (nxt < len(order) or any(slots_w)
           or any(q for q in queues.values())):
        while nxt < len(order) and arr[order[nxt]] <= tick:
            i = order[nxt]
            nxt += 1
            if slo_chunks is not None:
                ahead = sum(len(q) for c, q in queues.items()
                            if c <= pri[i])
                free_now = sum(r == 0 for r in slots_w)
                if expected_queue_wait(ahead, free_now, B,
                                       mean_chunks) > slo_chunks:
                    shed += 1
                    continue
            queues.setdefault(pri[i], []).append((tick, i))
        for s in range(B):
            if slots_w[s]:
                continue
            best = None
            for c in sorted(queues):
                if queues[c]:
                    eff = c - (tick - queues[c][0][0]) / aging
                    if best is None or eff < best[0]:
                        best = (eff, c)
            if best is None:
                break
            t0, i = queues[best[1]].pop(0)
            slots_w[s] = chunks_of[i]
            waits.append((pri[i], tick - t0))
        if any(slots_w):
            slots_w = [max(0, r - 1) for r in slots_w]
            tick += 1
        elif nxt < len(order):
            tick = max(tick + 1, arr[order[nxt]])
        else:
            break

    def _pct(vals, q_):
        if not vals:
            return 0.0
        vals = sorted(vals)
        return float(vals[min(len(vals) - 1,
                              int(math.ceil(q_ * len(vals))) - 1)])

    wait_by_class = {}
    for c in sorted(set(pri)):
        vs = [w for cc, w in waits if cc == c]
        wait_by_class[c] = {
            "p50": _pct(vs, 0.50), "p99": _pct(vs, 0.99),
            "mean": (sum(vs) / len(vs) if vs else 0.0), "n": len(vs)}
    all_waits = [w for _, w in waits]
    return {
        "requests": len(sweeps), "B": B, "check_every": k,
        "shape": tuple(shape) if shape is not None else None,
        "p": p, "q": q, "epilogue": epilogue, "dispatch_s": dispatch_s,
        "chunks": chunks, "refills": refills,
        "static_batches": static_batches,
        "occupancy_continuous": occupancy_continuous,
        "occupancy_static": occupancy_static,
        "busy_slot_chunks": busy_slot_chunks,
        "static_s": static_s, "continuous_s": continuous_s,
        "speedup": static_s / continuous_s if continuous_s > 0 else 0.0,
        "exact_hits": n_exact, "warm_starts": n_warm,
        "warm_sweeps": w_sweeps, "lookup_s": float(lookup_s),
        "nocache_continuous_s": nocache_continuous_s,
        "cache_speedup": (nocache_continuous_s / continuous_s
                          if continuous_s > 0 else 0.0),
        "wait_p50_chunks": _pct(all_waits, 0.50),
        "wait_p99_chunks": _pct(all_waits, 0.99),
        "wait_by_class": wait_by_class,
        "shed": shed,
    }


def serving_model(shape, B: int, p: int, q: int = 1, *,
                  sweeps: int = 12, epilogue: str = "allgather",
                  dtype_bytes: float = 4.0, dispatch_s: float = 1e-3,
                  compile_s: float = 0.0, iter_hist=None,
                  hw: HwSpec = V5E) -> Dict:
    """Analytic model of batched multi-tensor MSC serving (DESIGN.md §7.6).

    Per-request *work* is shape-determined: three modes of the 2-D
    sharded eigensolve (`eigensolve_model`) plus the similarity epilogue
    (`epilogue_model`).  What batching changes is the *fixed* per-
    dispatch cost `dispatch_s` — Python dispatch, executable launch, and
    the per-collective rendezvous latency that a small-tensor MSC
    request cannot hide — and the one-time `compile_s`:

      looped_s  = B · (dispatch_s + work_s)        one dispatch each
      batched_s = dispatch_s + B · work_s          one dispatch, B× payload
      speedup   = looped_s / batched_s  →  B as work_s/dispatch_s → 0

    so batching wins exactly when requests are dispatch-bound (the
    DBSCAN-MSC sweep regime: many small tensors), and degenerates to 1×
    when a single request saturates the machine.  compile_s amortizes
    across the executable-cache lifetime: `amortized_compile_s` is its
    share per request at this batch, zero once the bucket is warm.

    Returns a dict with the per-request work/byte terms (link bytes from
    the epilogue + inner-axis psum models, HBM bytes ≈ sweeps × the
    per-device eigensolve block re-read) and the latency/speedup terms.
    With `iter_hist` (per-request realized sweeps, arrival order) the
    "continuous" entry carries the `continuous_serving_model` occupancy
    prediction for the same shape/mesh (DESIGN.md §7.7).
    """
    m1, m2, m3 = shape
    work_s = 0.0
    link_bytes = 0.0
    hbm_bytes = 0.0
    # mode j slices are (m_j, r_j, c_j) with (r, c) the other two dims
    for m, r, c in ((m1, m2, m3), (m2, m1, m3), (m3, m1, m2)):
        eig = eigensolve_model(m, r, c, p, q, sweeps=sweeps,
                               dtype_bytes=dtype_bytes, hw=hw)
        epi = epilogue_model(m, c, p, epilogue=epilogue,
                             dtype_bytes=dtype_bytes, hw=hw)
        work_s += eig["latency_s"] + epi["latency_s"]
        link_bytes += eig["psum_link_bytes"] + epi["link_bytes"]
        hbm_bytes += sweeps * eig["block_bytes_per_device"]
    looped_s = B * (dispatch_s + work_s)
    batched_s = dispatch_s + B * work_s
    continuous = (continuous_serving_model(
        iter_hist, B, shape=shape, p=p, q=q, epilogue=epilogue,
        dispatch_s=dispatch_s, dtype_bytes=dtype_bytes, hw=hw)
        if iter_hist is not None else None)
    return {
        "continuous": continuous,
        "shape": tuple(shape), "B": B, "p": p, "q": q, "sweeps": sweeps,
        "epilogue": epilogue, "dtype_bytes": dtype_bytes,
        "dispatch_s": dispatch_s, "compile_s": compile_s,
        "work_per_request_s": work_s,
        "link_bytes_per_request": link_bytes,
        "hbm_bytes_per_request": hbm_bytes,
        "looped_s": looped_s, "batched_s": batched_s,
        "speedup": looped_s / batched_s if batched_s > 0 else 0.0,
        "amortized_compile_s": compile_s / max(B, 1),
        "cold_batched_s": compile_s + batched_s,
    }


def save_report(report: RooflineReport, path: str):
    import os

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report.to_json(), f, indent=2, default=str)
