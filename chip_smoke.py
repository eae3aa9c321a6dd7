#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure ends the script with a nonzero exit before the last
line):

1. The card: its `nvidia-smi` name and power limit, and the fp32
   matmul settings (TF32 off, stated).
2. The build: nvcc compiles every kernel source in
   `src/repro_torch/kernels/csrc/` in parallel; the `-Xptxas -v` report
   (registers, shared memory, spills) is printed per kernel.
3. Each CUDA kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it, with the tolerance stated; then
   its time (CUDA events over warm launches, and the device time of the
   same launches replayed from a CUDA graph), its bound, the plain
   version's time and the time of one library call that computes the
   same function (timed here only; the port never calls it): for bf16
   operands `torch.bmm(..., out_dtype=torch.float32)`, fp32 sums and an
   fp32 result as the kernels keep them (the rounded bf16 form of
   `batched_gram` is timed beside it, labelled).  `power_iter` is held
   and timed on every route it takes (`power_iter.routes`: general,
   direct, ring) at the main path's (1000, 1000, 1000), at c = 2048 (the
   register budget's edge) and at a ragged (37, 1003, 301);
   `batched_gram` also at c = 1, 127, 128, 129 (one tile, a mirror at
   the tile edge) and (5, 200, 1000) (a ragged last tile).  `power_iter`,
   `abs_rowsum` and `batched_gram` must give the same bits in two calls.
4. The main path at the paper's size: `launch/msc_run.py` at m = 1000
   (the 4 GB fp32 tensor of Fig. 6), γ = 1000, seed 0, the CLI's
   default ε, with each eigensolver.  Matrix-free: flat+kernels in fp32
   and bf16_fp32, sequential+kernels in fp32, and the einsum path in
   fp32 as this run's oracle.  Explicit gram (`--gram`, paper Alg. 1):
   the same four runs, held to the gram einsum oracle and to the
   matrix-free oracle.  Requires identical fp32 masks, sweeps equal or
   one gate chunk apart, finite d, every kernel of a path launched by
   its run (launch counts set to 0 just before each run and read just
   after), and no host read in any extraction (each runs under
   `torch.cuda.set_sync_debug_mode("error")`); prints each solve's time
   beside the one recorded before the trim moved to the device (PERF.md
   §5); then one flat+kernels fp32 run per
   eigensolver at γ = 10000 must recover the planted cluster (rec=1.000).
5. Batched serving: `msc_run --batch 2 --kernels` at m = 1000, with
   and without `--gram` (MSCServeEngine replaying CUDA graphs, seeds 0
   and 1 in one dispatch).  Each request must give the masks of the
   single-tensor flat run of its seed, with sweeps equal or one gate
   chunk apart; the engine must capture its graphs cold and none warm,
   hold no more device memory than its static buffers and graph pools,
   and leave 0 B once closed.  Prints the warm and looped-warm times,
   the speedup and the peak device memory.
5b. Static serving: `launch/msc_serve.py` at the reference's defaults
   (9 requests over m = 16, 21, 33, B = 4) must capture 9 graphs per
   bucket cold (a head, a gate chunk and a tail per mode) and none warm.
   Then MSCServeEngine with kernels, fp32, B = 4, on 8 planted requests
   over m = 200 and 400 (γ = m; the low end of paper Fig. 6): each
   request's masks, d and sweeps equal the eager runner's
   (`build_msc_batched`) bit for bit on the same microbatch, and its
   masks equal msc_sequential's with sweeps one gate chunk apart at
   most; prints the warm times of the graphed engine, the eager runner
   and the looped B = 1 engine.
5c. Continuous serving: `launch/msc_serve.py --continuous` at the
   reference's defaults (9 requests over m = 16, 21, 33, 4 slots) must
   capture 2 graphs per bucket (the chunk step and the refill) warming
   up and none in the stream.  Then MSCContinuousEngine with kernels,
   fp32, 8 slots, on the skewed mix of `benchmarks/msc_continuous.py`
   (32 requests at m = 200, every 8th near-noise, gamma = 2, the rest
   gamma = 300; that benchmark's gate): masks and sweeps identical across
   three interleavings (arrival order, placement, refill batching) and to
   the graphed static engine (B = 8, d within 3e-5), masks equal
   msc_sequential's with sweeps one gate chunk apart at most on requests
   0, 1 and 9; 2 graphs captured cold and none warm; no host sync in any
   replay; `power_iter` launches = 3 x step replays and `abs_rowsum`
   launches = 3 x refill replays in a warm run; the live engine within
   its static buffers + graph pool and 0 B left once closed.  Prints the
   warm walls of both engines in turns, their ratio, the occupancy,
   refills, evictions and the sweep histogram.
6. `flash_attention` against its plain version at the LM path's shapes
   (whisper-tiny at batch 16: the encoder's self-attention and the
   prefill and decode cross-attention over 1500 frames), at gemma2-27b's
   (b·h = 32, s = 8192, d = 128, causal, softcap 50, global and with
   the 4096 window), on small ragged cases with q_offset and at the
   routes' edges (sq on both sides of SQ_SMALL and of a 64-row tile,
   skv of 1, 63 and 65, d = 256 causal, a window at d = 32), in fp32
   and bf16; at the encoder shape in bf16 at most 1% of the outputs may
   differ from the plain version's (a P rounded to bf16 moves many).
   Then its times, bound, plain time and the time of
   `F.scaled_dot_product_attention` where it computes the same function,
   and both routes timed at sq = 1, 2, 4, 8, 16, 32 (the evidence
   for SQ_SMALL).
7. LM serving: `launch/serve.py --arch whisper-tiny --batch 16
   --prompt-len 32 --gen 16 --attn-impl pallas` at full size (random
   weights from seed 0), twice, each launching `flash_attention` exactly
   n_enc_layers + n_layers + n_layers·gen = 72 times and no other
   kernel; the same with the plain route (`--attn-impl chunked`) for
   its times.  Then the kernel route against the plain route on the
   same weights by teacher forcing (both fed the plain route's tokens):
   prefill and per-step logits within 2e-2 of max |logit| in bf16 and
   1e-4 in fp32, and identical greedy tokens in fp32.  The engine's
   decode step replayed from one CUDA graph against an eager loop of
   `decode_step`: identical greedy tokens in fp32, the last step's
   logits within the same tolerances, no host sync in the replays; the
   decode ms per token of both.  Prints prefill ms, decode ms per
   token, tokens/s and the peak device memory.
8. The parallel schedules on a mesh: one NCCL process group of one rank
   (a FileStore in a temporary directory; NCCL takes one rank per card),
   phase 4's tensor (m = 1000, γ = 1000, seed 0, the CLI's ε, kernels
   on) through `build_msc_parallel(..., mesh=...)` five ways: flat (1,)
   gspmd allgather fp32, (1,) collective ring fp32, (1, 1)
   collective_stream allgather fp32 (the inner dim: one `power_matvec`
   per sweep and an all_reduce), (1, 1) `--gram` fp32 and (1,)
   bf16_fp32.  The (1,) runs must give phase 4's one-device masks,
   sweeps, d and λ bit for bit; the (1, 1) runs its masks, sweeps equal
   or one gate chunk apart and d within 3e-5.  Every kernel of a run
   launched (counts set to 0 just before the warm run and read just
   after), no host read in an extraction, and 0 B left once the process
   group and the tensors are freed.  Prints each warm solve time beside
   phase 4's, the peak memory and the NCCL version.
9. MSC serving on a mesh of one NCCL rank: phase 5b's static cells
   (m = 200 and 400, B = 4, fp32, kernels) through MSCServeEngine on
   (1,) and (1, 1) under each relayout (gspmd, collective,
   collective_stream), and phase 5c's skewed mix (m = 200, 32 requests, 8
   slots) through MSCContinuousEngine on (1,); then `msc_serve
   --mesh-shape 1 --continuous` at the reference's defaults and
   `msc_run --batch 2 --mesh-shape 1 --kernels` at m = 1000 (the CLIs'
   rank bodies in this process's group).  Required: the one-device
   engines' bits on (1,) (phase 5's `--batch 2` too), masks and sweeps
   on (1, 1) (d within 3e-5); 9 graphs per bucket (static) and 2
   (continuous) captured cold with the collectives inside, none warm;
   no host sync in a replay; every kernel of a run launched (counts set
   to 0 just before the warm run and read just after); 0 B left once
   closed.  Prints each warm time beside the one-device engine's, run
   in turns.
10. LM serving on a (data, model) = (1, 1) mesh of one NCCL rank:
   `serve --model-axis 1` on whisper-tiny at phase 7's size (batch 16,
   prompt 32, 16 tokens, kernel route), twice: 72 `flash_attention`
   launches and no other kernel; prefill, decode per token and peak
   memory beside phase 7's.  Then per compute dtype (bf16, fp32) the
   mesh engine against the one-device engine on the same weights: fp32
   tokens identical (and to phase 7's), teacher-forced logits within
   2e-2 / 1e-4 of max |logit|, the decode step one CUDA graph with no
   host sync in its replays; warm prefill and decode beside the
   one-device engine's; 0 B left once the group is gone.

The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA card, or
outside a checkout of the repository, it exits nonzero and prints no
result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

M, GAMMA, SEED = 1000, 1000.0, 0
# signal weight of the recovery run: at γ = m = 1000 every path, the
# einsum oracle included, trims the planted cluster below its size (the
# spread of d over the cluster exceeds Theorem II.1's bound); at
# γ = 10 m the spread shrinks below it (PERF.md, Findings)
GAMMA_RECOVERY = 10000.0
DEVICE = "cuda"
# what a phase keeps for a later one (phase 5b/5c's requests and results,
# phase 7's times and fp32 tokens for the mesh phases 9 and 10)
STASH = {}


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, reps, warmup=2):
    """Mean milliseconds per call over `reps` warm calls (CUDA events)."""
    for _ in range(warmup):
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


def graph_ms(torch, fn, reps):
    """Mean device milliseconds per call: `reps` calls captured in one
    CUDA graph and replayed, so the host's time to launch each call (the
    wrapper's checks, allocation and ctypes call) leaves no gap between
    kernels.  None if the calls cannot be captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()  # warm: kernel attributes are set outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        del graph
        return start.elapsed_time(end) / reps
    except Exception as e:  # noqa: BLE001 - reported, and the run goes on
        log(f"  graph timing failed ({type(e).__name__}: {e})")
        return None


def fmt_ms(t):
    return "n/a" if t is None else f"{t:.4f} ms"


def bound_ms(n_bytes, flops, dtype):
    """(least time in ms, "bytes" | "operations") at the published peaks."""
    t_mem = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def bmm_fp32(torch, a, b):
    """torch.bmm(a, b) with fp32 sums and an fp32 result for bf16 operands
    (the `out_dtype` overload); where this torch refuses it, the product
    in the operands' dtype, upcast (a rounded result, said once)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    try:
        return torch.bmm(a, b, out_dtype=torch.float32)
    except (TypeError, RuntimeError) as e:
        if not getattr(bmm_fp32, "said", False):
            log(f"  torch.bmm(..., out_dtype=torch.float32) refused "
                f"({type(e).__name__}: {str(e).splitlines()[0]}); the bf16 "
                "library forms round their results to bf16")
            bmm_fp32.said = True
        return torch.bmm(a, b).float()


class Checks:
    """Kernel-against-plain comparisons; failures are collected."""

    def __init__(self):
        self.failures = []
        self.max_abs = {}

    def compare(self, kernel, label, got, want, tol, scales=None):
        """Each output's max |kernel − plain| must be within tol of its
        scale: the largest |plain| entry, or the given scale."""
        import torch

        errs = []
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = g.double(), w.double()
            scale = w.abs().max().item() if scales is None or \
                scales[i] is None else scales[i]
            errs.append(((g - w).abs().max().item(), scale))
        max_abs = max(e for e, _ in errs)
        rel = max(e / max(s, 1e-30) for e, s in errs)
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        ok = finite and rel <= tol
        self.max_abs[kernel] = max(self.max_abs.get(kernel, 0.0), max_abs)
        log(f"  {'ok  ' if ok else 'FAIL'} {label}: max_abs_err={max_abs:.3e} "
            f"rel={rel:.3e} (tol {tol:g} of the scale)")
        if not ok:
            self.failures.append(f"{label}: rel {rel:.3e} > {tol:g} or "
                                 "non-finite")


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device: {torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {len(built)} libraries in {time.perf_counter() - t0:.2f} s "
        f"(wall, nvcc in parallel)")
    keep = ("Compiling entry function", "Function properties", "spill",
            "Used")
    for b in built.values():
        log(f"  {b.name}: nvcc {b.seconds:.2f} s -> {b.path.name}")
        for line in b.ptxas.splitlines():
            if any(k in line for k in keep):
                log(f"    {line.strip()}")


def phase_kernels(torch, checks):
    """Each kernel against its plain version; returns the timing rows."""
    from repro_torch.kernels import power_iter as kpi
    from repro_torch.kernels import ref
    from repro_torch.kernels import ring as kring

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = {}
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
    log("kernels against plain versions (tolerance relative to the largest "
        "plain entry: fp32 1e-4 for sums in another order; bf16 3e-2, since "
        "a sum on the other side of a bf16 rounding moves an operand by "
        "2^-8 and later sweeps carry it on)")

    # ---- power_iter: slices (1000, 1000, 1000), the main path's mode
    # slices, on every route the kernel takes there
    b = r = c = M
    t32 = torch.randn((b, r, c), generator=gen, device=dev)
    v0 = torch.randn((b, c), generator=gen, device=dev)
    v0 /= v0.norm(dim=-1, keepdim=True)
    k = 6

    def power_cases(label, s, v, n_iter=60):
        """Each entry point on the route `route()` picks and on every
        route forced, against the plain version; each chunk again with a
        same-bits check."""
        plain = ref.power_iterate_chunk(s, v, k)
        plain_it = ref.power_iterate(s, v, n_iter)
        plain_mv = (ref.power_matvec(s, v),)
        for route in (None,) + kpi.routes(s.shape[-1], s.dtype):
            tag = f"{label} route={route or kpi.route(s.shape[-1], s.dtype)}"
            tag += "" if route else " (auto)"
            got = kpi.power_iterate_chunk(s, v, k, route=route)
            # resid = ‖w − λv‖ is rounding noise on a converged slice: it
            # is held to the scale of λ
            checks.compare("power_iter", f"power_iterate_chunk k={k} {tag}",
                           got, plain, tol[s.dtype],
                           [None, None, plain[1].abs().max().item()])
            # the partials add in a fixed order: a second call gives the
            # same bits (the trim and the max-gap extraction read d)
            again = kpi.power_iterate_chunk(s, v, k, route=route)
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                checks.failures.append(f"power_iterate_chunk {tag}: two "
                                       "calls differ")
            checks.compare("power_iter", f"power_iterate n={n_iter}+lambda "
                           f"{tag}", kpi.power_iterate(s, v, n_iter,
                                                       route=route),
                           plain_it, tol[s.dtype])
            checks.compare("power_iter", f"power_matvec {tag}",
                           (kpi.power_matvec(s, v, route=route),), plain_mv,
                           tol[s.dtype])

    for dt in (torch.float32, torch.bfloat16):
        s = t32.to(dt)
        name = str(dt).split(".")[-1]
        power_cases(f"{name} {tuple(s.shape)}", s, v0)
        elt = s.element_size()
        n_bytes = b * r * c * elt + 2 * b * c * 4 + 2 * b * 4
        flops = 4 * b * r * c * k
        bms, by = bound_ms(n_bytes, flops, name)

        def library():  # two torch.bmm per sweep, operands in dtype dt,
            v = v0.to(dt)  # w summed and kept in fp32 (as the kernel does)
            for _ in range(k):
                tv = torch.bmm(s, v.unsqueeze(-1))
                v = bmm_fp32(torch, tv.transpose(1, 2), s).squeeze(1).to(dt)
            return v

        def chunk_on(route):
            return lambda: kpi.power_iterate_chunk(s, v0, k, route=route)

        row = {
            "ms": cuda_ms(torch, chunk_on(None), 5),
            "route": kpi.route(c, dt),
            "route_ms": {rt: cuda_ms(torch, chunk_on(rt), 5)
                         for rt in kpi.routes(c, dt)},
            "plain_ms": cuda_ms(
                torch, lambda: ref.power_iterate_chunk(s, v0, k), 3, 1),
            "library_ms": cuda_ms(torch, library, 3, 1),
            "bound_ms": bms, "bound_by": by,
            "sweep_bound_ms": k * b * r * c * elt / HBM_BYTES_PER_S * 1e3,
        }
        # waves: one CTA per slice; the tail is the time above what a
        # whole number of waves takes per slice
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        row["waves"] = {}
        for rt in (rt for rt in kpi.routes(c, dt) if rt != "general"):
            slots = kpi.ctas_per_sm(c, dt, rt) * sms
            full = b // slots * slots
            w = row["waves"][rt] = {"ctas_per_sm": slots // sms,
                                    "waves": b / slots,
                                    "whole_waves_slices": full}
            if 0 < full < b:
                w["whole_waves_ms"] = cuda_ms(
                    torch, lambda: kpi.power_iterate_chunk(
                        s[:full], v0[:full], k, route=rt), 5)
                w["tail_ms"] = (row["route_ms"][rt]
                                - w["whole_waves_ms"] * b / full)
            log(f"  waves power_iterate_chunk {name} route {rt}: "
                f"{w['ctas_per_sm']} CTAs per SM x {sms} SMs, {b} slices = "
                f"{w['waves']:.2f} waves; {full} slices (whole waves) "
                f"{fmt_ms(w.get('whole_waves_ms'))}, tail "
                f"{fmt_ms(w.get('tail_ms'))} (the {b} slices' time above "
                "the whole waves' time per slice)")
        rows[("power_iter", name)] = row
        routes = ", ".join(f"{rt} {t:.3f} ms"
                           for rt, t in row["route_ms"].items())
        log(f"  time power_iterate_chunk k={k} {name}: kernel "
            f"{row['ms']:.3f} ms (route {row['route']}; every route: "
            f"{routes}), plain {row['plain_ms']:.3f} ms, library "
            f"(2 torch.bmm per sweep, w in fp32) {row['library_ms']:.3f} ms, "
            f"bound {bms:.3f} ms ({by}; T read once), streaming bound "
            f"{row['sweep_bound_ms']:.3f} ms (T read once per sweep)")
        del s
    del t32
    torch.cuda.empty_cache()

    # the register budget's edge (c = 2048: fp32 streams on the ring only)
    # and ragged r and c (the general route, tile rows cut mid-slice)
    for shape in ((64, 500, 2048), (37, 1003, 301)):
        x32 = torch.randn(shape, generator=gen, device=dev)
        v = torch.randn((shape[0], shape[2]), generator=gen, device=dev)
        v /= v.norm(dim=-1, keepdim=True)
        for dt in (torch.float32, torch.bfloat16):
            power_cases(f"{str(dt).split('.')[-1]} {shape}", x32.to(dt), v,
                        n_iter=12)
        del x32
    torch.cuda.empty_cache()

    # ---- abs_rowsum: V (1000, 1000) against itself, the flat epilogue
    # the flat epilogue's (1000, 1000) and a request-batched ragged c
    # (single-element loads), each with and without acc
    cases = [((M, M), (M, M)), ((4, 300, 257), (4, 300, 257)),
             ((77, 301), (1003, 301)), ((3, M, 301), (3, M, 301))]
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        for sa, sb in cases:
            a = torch.randn(sa, generator=gen, device=dev).to(dt)
            bb = torch.randn(sb, generator=gen, device=dev).to(dt)
            acc = torch.rand(sa[:-1], generator=gen, device=dev)
            for ac in (None, acc):
                got = kring.abs_rowsum(a, bb, ac)
                checks.compare("abs_rowsum", f"abs_rowsum {name} {sa}x{sb} "
                               f"acc={'yes' if ac is not None else 'no'}",
                               (got,), (ref.abs_rowsum(a, bb, ac),), tol[dt])
                # the j-partials are added in a fixed order: a second call
                # gives the same bits (the trim and max-gap read d)
                if not torch.equal(got, kring.abs_rowsum(a, bb, ac)):
                    checks.failures.append(f"abs_rowsum {name} {sa}x{sb}: "
                                           "two calls differ")
        a = torch.randn((M, M), generator=gen, device=dev).to(dt)
        elt = a.element_size()
        bms, by = bound_ms(2 * M * M * elt + M * 4, 2 * M * M * M, name)
        row = {
            "ms": cuda_ms(torch, lambda: kring.abs_rowsum(a, a), 20),
            "device_ms": graph_ms(torch, lambda: kring.abs_rowsum(a, a), 20),
            "plain_ms": cuda_ms(torch, lambda: ref.abs_rowsum(a, a), 20),
            "library_ms": cuda_ms(
                torch, lambda: torch.matmul(a, a.T).abs().sum(1), 20),
            "bound_ms": bms, "bound_by": by,
        }
        rows[("abs_rowsum", name)] = row
        log(f"  time abs_rowsum {name} ({M}, {M}) x ({M}, {M}): kernel "
            f"{row['ms']:.4f} ms (device time from a CUDA graph "
            f"{fmt_ms(row['device_ms'])}), plain {row['plain_ms']:.3f} ms, library "
            f"(matmul(a, b.T).abs().sum(1)) {row['library_ms']:.3f} ms, "
            f"bound {bms:.4f} ms ({by})")
    del a, bb, acc
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rows.update(phase_gram(torch, checks, gen))
    return rows


def phase_gram(torch, checks, gen):
    """batched_gram against its plain version, and its times at the main
    path's mode slices (1000, 1000, 1000) with the fp32 result the
    solver asks for."""
    from repro_torch.kernels import gram as kgram
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    dev = torch.device(DEVICE)
    # fp32 result: sums in another order; bf16 result: a sum on the
    # other side of a bf16 rounding boundary moves the entry by 2^-8
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
    log("batched_gram against its plain version (tolerance relative to "
        "the largest plain entry: 1e-5 for an fp32 result, 1e-2 for a "
        "bf16 result)")
    rows = {}
    # the main path's slices; ragged r and c (single-element loads);
    # request-batched; one tile (c = 1, 127), a mirror at the edge of one
    # and two tiles (128, 129); an aligned c with a ragged last tile
    cases = [(M, M, M), (37, 1003, 301), (2, 300, 257, 131), (3, 50, 1),
             (3, 50, 127), (3, 50, 128), (3, 50, 129), (5, 200, M)]
    for shape in cases:
        x = torch.randn(shape, generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            s = x.to(dt)
            name = str(dt).split(".")[-1]
            for out in (None, torch.float32):
                got = ops.batched_gram(s, out_dtype=out)
                want = ref.batched_gram(s, out)
                label = f"batched_gram {name} {shape} out={str(got.dtype)[6:]}"
                checks.compare("batched_gram", label, (got.float(),),
                               (want.float(),), tol[got.dtype])
                # sums in a fixed order: a second call gives the same bits
                if not torch.equal(got, ops.batched_gram(s, out_dtype=out)):
                    checks.failures.append(f"{label}: two calls differ")
                del got, want
            if shape == (M, M, M):
                b, r, c = shape
                # C is symmetric: the function needs one triangle's
                # r·c(c+1)/2 multiply-adds per slice; the fp32 result is
                # written in full
                bms, by = bound_ms(b * r * c * s.element_size()
                                   + b * c * c * 4, b * r * c * (c + 1), name)
                fp32 = torch.float32
                row = {
                    "ms": cuda_ms(torch, lambda: kgram.batched_gram(
                        s, out_dtype=fp32), 3, 1),
                    "plain_ms": cuda_ms(
                        torch, lambda: ref.batched_gram(s, fp32), 3, 1),
                    # the same function: fp32 sums, an fp32 C
                    "library_ms": cuda_ms(
                        torch, lambda: bmm_fp32(torch, s.mT, s), 3, 1),
                    "bound_ms": bms, "bound_by": by,
                }
                if dt == torch.bfloat16:
                    # the rounded form, bf16 C: not the same function
                    row["library_rounded_ms"] = cuda_ms(
                        torch, lambda: torch.bmm(s.mT, s), 3, 1)
                    lib = (f"(torch.bmm(t.mT, t, out_dtype=torch.float32)) "
                           f"{row['library_ms']:.3f} ms, rounded to a bf16 "
                           f"C (torch.bmm(t.mT, t)) "
                           f"{row['library_rounded_ms']:.3f} ms")
                else:
                    lib = f"(torch.bmm(t.mT, t)) {row['library_ms']:.3f} ms"
                rows[("batched_gram", name)] = row
                log(f"  time batched_gram {name} {shape} -> fp32: kernel "
                    f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
                    f"library {lib}, bound {bms:.3f} ms ({by})")
            del s
        del x
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return rows


def gate_trace(torch, cfg):
    """Per mode, the gate value max-weighted-residual / λ_max after each
    chunk (fires at <= power_tol), on the CLI's m = 1000 tensor."""
    from repro_torch.core import PlantedSpec, make_planted_tensor
    from repro_torch.core import power_iter as cpi
    from repro_torch.core.msc import mode_slices

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    t = make_planted_tensor(gen, PlantedSpec.paper(M, GAMMA))
    out = []
    for j in range(3):
        s = mode_slices(t, j)
        chunk_fn, k = cpi.build_chunk_fn(s, cfg)
        state = cpi.init_solve_state(cpi._init_vectors(
            s.shape[:-2], s.shape[-1], device=s.device))
        vals = []
        while cpi._any_active(state, cfg.power_iters):
            state = cpi.step_chunk(chunk_fn, state, k=k,
                                   n_iters=cfg.power_iters,
                                   tol=cfg.power_tol)
            lam, res = state.lam, state.resid
            w = torch.amax(res / torch.clamp(lam, min=1.0) * lam)
            vals.append(float(w / torch.clamp(lam.amax(), min=1e-30)))
        out.append(vals)
        del s
    return out


KERNELS = ("power_iter", "abs_rowsum", "batched_gram", "flash_attention")


def counters():
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import gram as kgram
    from repro_torch.kernels import power_iter as kpi
    from repro_torch.kernels import ring as kring

    return {"power_iter": kpi, "abs_rowsum": kring, "batched_gram": kgram,
            "flash_attention": kfa}


class NoHostReadsInExtraction:
    """While active, every `extract_cluster` of the MSC paths runs under
    `torch.cuda.set_sync_debug_mode("error")`: a read back to the host
    inside an extraction raises.  `calls` counts the extractions."""

    def __init__(self, torch):
        from repro_torch.core import msc, schedule

        self.torch, self.mods, self.calls = torch, (msc, schedule), 0
        self.orig = schedule.extract_cluster

    def guarded(self, *a, **kw):
        self.calls += 1
        self.torch.cuda.set_sync_debug_mode("error")
        try:
            return self.orig(*a, **kw)
        finally:
            self.torch.cuda.set_sync_debug_mode("default")

    def __enter__(self):
        for mod in self.mods:
            mod.extract_cluster = self.guarded
        return self

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.extract_cluster = self.orig


def drive(torch, label, argv, mesh_device=None):
    """One `msc_run` run with every launch count set to 0 just before it
    and read just after, and no host read allowed in its extractions (on
    the mesh of this process's group with `mesh_device`, the CLI's rank
    body).  Returns (what run() returned, counts)."""
    from repro_torch.launch import msc_run

    log(f"main path: {label}")
    mods = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    t0 = time.perf_counter()
    with NoHostReadsInExtraction(torch) as guard:
        if mesh_device is None:
            out = msc_run.run(msc_run.parse_args(argv))
        else:
            out = msc_run._run(msc_run.parse_args(argv), mesh_device, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: mod.launches for n, mod in mods.items()}
    log(f"  wall {wall:.2f} s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{counts}, {guard.calls} extractions with no host read")
    return out, counts


def hold(torch, checks, label, res, oracle, oracle_name, chunk):
    """Masks identical to the oracle's; sweeps equal or one gate chunk
    apart.  Returns the modes whose sweeps differ."""
    diverged = []
    for j in range(3):
        same = torch.equal(res[j].mask.cpu(), oracle[j].mask.cpu())
        dd = ((res[j].d.cpu() - oracle[j].d.cpu()).abs().max()
              / oracle[j].d.abs().max().cpu()).item()
        got, want = int(res[j].power_iters_run), int(
            oracle[j].power_iters_run)
        log(f"  {label} mode {j}: mask == {oracle_name} {same}, d rel diff "
            f"{dd:.3e}, sweeps {got} vs {want}")
        if not same:
            checks.failures.append(f"{label} mode {j}: mask differs from "
                                   f"{oracle_name}")
        gap = abs(got - want)
        if gap > chunk:
            checks.failures.append(f"{label} mode {j}: sweeps more than one "
                                   f"gate chunk from {oracle_name}")
        if gap:
            diverged.append(j)
    return diverged


# warm solve walls at m = 1000 while the trim loop still read the host once
# per member dropped (PERF.md §5: tools/torch_profile.py, two runs; NVIDIA
# H100 80GB HBM3, 700 W), printed beside this run's
HOST_TRIM_WALL_MS = {"flat+kernels fp32": "359.0 / 383.8",
                "flat+kernels bf16_fp32": "309.2 / 288.9",
                "flat+kernels gram fp32": "461.4 / 460.7",
                "flat+kernels gram bf16_fp32": "417.6 / 395.4"}


def main_cfg():
    """The MSCConfig `msc_run` builds at m = M (its gate chunk too)."""
    from repro_torch.core import MSCConfig

    return MSCConfig(epsilon=0.5 / (M - M // 10) ** 2, max_extraction_iters=M)


def phase_main_path(torch, checks):
    """Both eigensolvers at m = 1000 through the CLI.  Returns
    ({label: counts}, {label: MSCResult}, {label: solve ms})."""
    base = ["--m", str(M), "--gamma", str(GAMMA), "--seed", str(SEED),
            "--device", DEVICE]
    recovery = ["--gamma", str(GAMMA_RECOVERY)]
    cfg = main_cfg()
    chunk = cfg.power_check_every
    # (label, extra argv, kernels the run must launch)
    runs = []
    for solver, flag in (("", []), ("gram ", ["--gram"])):
        solve = ("batched_gram",) if flag else ("power_iter",)
        runs += [
            (f"flat+kernels {solver}fp32", ["--kernels", *flag],
             solve + ("abs_rowsum",)),
            (f"flat+kernels {solver}bf16_fp32",
             ["--kernels", "--precision", "bf16_fp32", *flag],
             solve + ("abs_rowsum",)),
            (f"sequential+kernels {solver}fp32",
             ["--schedule", "sequential", "--kernels", *flag], solve),
            (f"flat einsum {solver}fp32 (oracle)", flag, ()),
            (f"flat+kernels {solver}fp32 gamma={GAMMA_RECOVERY:g} "
             "(recovery)", ["--kernels", *recovery, *flag],
             solve + ("abs_rowsum",)),
        ]
    results, launches, solve_ms = {}, {}, {}
    for label, extra, want in runs:
        out, counts = drive(torch, label, base + extra)
        rec = out[0]
        launches[label] = counts
        results[label] = rec["result"]
        solve_ms[label] = rec["t"] * 1e3
        before = (f"; with the host-driven trim: {HOST_TRIM_WALL_MS[label]} "
                  "ms" if label in HOST_TRIM_WALL_MS else "")
        log(f"  solve t={rec['t'] * 1e3:.1f} ms{before} (the rest of the wall "
            f"time is data and the sim metric), rec={rec['rec']:.3f}")
        if label.endswith("(recovery)") and rec["rec"] != 1.0:
            checks.failures.append(f"{label}: rec={rec['rec']:.3f} != 1.000")
        for mr in rec["result"].modes:
            if not bool(torch.isfinite(mr.d).all()):
                checks.failures.append(f"{label}: non-finite d")
        for n in KERNELS:
            if n in want and counts[n] == 0:
                checks.failures.append(f"{label}: {n} never launched")
            if n not in want and counts[n]:
                checks.failures.append(f"{label}: {n} ran off its path")

    mf_oracle = results["flat einsum fp32 (oracle)"]
    gram_oracle = results["flat einsum gram fp32 (oracle)"]
    for label in ("flat+kernels fp32", "sequential+kernels fp32"):
        for j in hold(torch, checks, label, results[label], mf_oracle,
                      "oracle", chunk):
            log(f"  sweeps diverge ({label}, mode {j}); gate values per "
                "chunk (fires at <= power_tol 1e-2):")
            for name, c in ((label, cfg.with_(use_kernels=True)),
                            ("oracle", cfg)):
                log(f"    {name}: {gate_trace(torch, c)[j]}")
    for label in ("flat+kernels gram fp32", "sequential+kernels gram fp32",
                  "flat einsum gram fp32 (oracle)"):
        if "oracle" not in label:
            hold(torch, checks, label, results[label], gram_oracle,
                 "gram oracle", chunk)
        hold(torch, checks, label, results[label], mf_oracle,
             "matrix-free oracle", chunk)
    return launches, results, solve_ms


def phase_batched(torch, checks, singles):
    """--batch 2 at m = 1000 with and without --gram, each request held
    to the single-tensor flat run of its seed."""
    def argv(seed, *extra):
        return ["--m", str(M), "--gamma", str(GAMMA), "--seed", str(seed),
                "--device", DEVICE, "--kernels", *extra]

    chunk = main_cfg().power_check_every
    launches = {}
    for solver, flag in (("", []), ("gram ", ["--gram"])):
        label = f"batch 2 flat+kernels {solver}fp32"
        seed1 = f"flat+kernels {solver}fp32 seed 1"
        out, _ = drive(torch, seed1, argv(SEED + 1, *flag))
        singles[seed1] = out[0]["result"]
        out, counts = drive(torch, label, argv(SEED, "--batch", "2", *flag))
        launches[label] = counts
        cold, warm = out["stats_cold"], out["stats_warm"]
        log(f"  cold {out['cold']:.3f} s, warm {out['warm']:.3f} s, "
            f"looped-warm {out['loop_warm']:.3f} s, speedup="
            f"{out['loop_warm'] / out['warm']:.2f}x, CUDA graphs captured "
            f"{cold.compiles} cold / {warm.compiles} warm")
        if cold.compiles != GRAPHS_PER_BUCKET or warm.compiles:
            checks.failures.append(f"{label}: {cold.compiles} graphs captured "
                                   f"cold, {warm.compiles} warm")
        # the live engine holds its bucket's static buffers and graph pool
        # and no more; once closed it leaves nothing (a buffer kept by a
        # closure, a gram held past its mode, would show here)
        static, pools = out["reckoned"]
        log(f"  device memory held by the live engine {out['held']} B, "
            f"reckoned {static} B static + {pools} B graph pools; left "
            f"once closed {out['left']} B (looped engine {out['loop_left']} "
            "B)")
        if out["held"] > static + pools:
            checks.failures.append(f"{label}: the live engine holds "
                                   f"{out['held']} B > {static + pools} B")
        if (out["left"], out["loop_left"]) != (0, 0):
            checks.failures.append(
                f"{label}: device memory left allocated once closed, "
                f"{out['left']} B (B = 2) and {out['loop_left']} B (B = 1)")
        solve = "batched_gram" if flag else "power_iter"
        for n in (solve, "abs_rowsum"):
            if counts[n] == 0:
                checks.failures.append(f"{label}: {n} never launched")
        singles[label] = out  # phase 9 holds the mesh's --batch to it
        for i, res in enumerate(out["results"]):
            one = singles[f"flat+kernels {solver}fp32" + (" seed 1" if i
                                                          else "")]
            hold(torch, checks, f"{label} req {i}", res, one,
                 f"single-tensor run of seed {i}", chunk)
    return launches


# MSCServeEngine's CUDA graphs per bucket: a head, a gate chunk and a tail
# for each of the three modes
GRAPHS_PER_BUCKET = 9
# static serving at the low end of paper Fig. 6: two buckets, B = 4
SERVE_SIZES, SERVE_REQUESTS, SERVE_B = (200, 400), 8, 4


def _timed_s(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_static(torch, checks):
    """msc_serve at the reference's defaults, then the engine with kernels
    at m = 200 and 400 held to the eager runner and to msc_sequential.
    Returns {label: launch counts} of the engine's warm run."""
    import numpy as np

    from repro_torch.core import (MSCConfig, PlantedSpec, make_planted_tensor,
                                  msc_sequential)
    from repro_torch.core.parallel import build_msc_batched
    from repro_torch.launch import msc_serve
    from repro_torch.serving import MSCServeEngine

    log("static serving: msc_serve at the reference's defaults")
    with NoHostReadsInExtraction(torch):
        res = msc_serve.run(msc_serve.parse_args(["--device", DEVICE]))
    eng, cold, warm = res["engine"], res["stats_cold"], res["stats_warm"]
    want = GRAPHS_PER_BUCKET * len(res["buckets"])
    ok = (len(res["buckets"]) == 3 and cold.compiles == eng.graphs == want
          and warm.compiles == 0)
    log(f"  {'ok  ' if ok else 'FAIL'} CUDA graphs captured: {cold.compiles} "
        f"cold (want {want}: {GRAPHS_PER_BUCKET} x {len(res['buckets'])} "
        f"buckets), {warm.compiles} warm; warm {res['warm'] * 1e3:.1f} ms, "
        f"looped B=1 {res['loop_warm'] * 1e3:.1f} ms")
    if not ok:
        checks.failures.append(f"msc_serve: {cold.compiles} graphs captured "
                               f"cold, {warm.compiles} warm, want {want}, 0")
    eng.close()
    del res, eng

    label = (f"static serving kernels fp32 m={'/'.join(map(str, SERVE_SIZES))}"
             f" B={SERVE_B}")
    log(f"{label}: {SERVE_REQUESTS} planted requests (gamma = m)")
    cfg = MSCConfig(epsilon=0.5 / (max(SERVE_SIZES)
                                   - max(SERVE_SIZES) // 10) ** 2,
                    use_kernels=True)
    tensors = [make_planted_tensor(
        torch.Generator(device=DEVICE).manual_seed(SEED + i),
        PlantedSpec.paper(m, float(m)))
        for i, m in enumerate(SERVE_SIZES * (SERVE_REQUESTS
                                             // len(SERVE_SIZES)))]
    groups = {m: [i for i, t in enumerate(tensors) if t.shape[0] == m]
              for m in SERVE_SIZES}
    runner = build_msc_batched(cfg, device=DEVICE)

    def eager(ms=SERVE_SIZES):
        """The eager runner on each bucket's microbatch, results to the
        host, as the engine returns them."""
        out = {}
        for m in ms:
            idx = groups[m]
            batch = torch.stack([tensors[i] for i in idx])
            dims = np.tile(np.int32([m, m, m]), (len(idx), 1))
            res = runner(batch, dims)
            out[m] = [(mr.mask.cpu(), mr.d.cpu(), mr.lambdas.cpu(),
                       mr.power_iters_run.tolist()) for mr in res.modes]
        return out

    engine = MSCServeEngine(cfg, max_batch=SERVE_B, device=DEVICE)
    loop = MSCServeEngine(cfg, max_batch=1, device=DEVICE)
    with NoHostReadsInExtraction(torch):
        engine.run(tensors)
        loop.run(tensors)
    mods = counters()
    for mod in mods.values():
        mod.launches = 0
    got = engine.run(tensors)
    counts = {n: mod.launches for n, mod in mods.items()}
    for n in ("power_iter", "abs_rowsum"):
        if counts[n] == 0:
            checks.failures.append(f"{label}: {n} never launched")
    want_e = eager()
    same = True
    for m, idx in groups.items():
        for s_, i in enumerate(idx):
            for j in range(3):
                mask, d, lam, sweeps = want_e[m][j]
                g = got[i][j]
                same &= (torch.equal(g.mask, mask[s_])
                         and torch.equal(g.d, d[s_])
                         and torch.equal(g.lambdas, lam[s_])
                         and g.power_iters_run == sweeps[s_])
    log(f"  {'ok  ' if same else 'FAIL'} every request's masks, d, λ and "
        "sweeps equal the eager runner's bit for bit")
    if not same:
        checks.failures.append(f"{label}: the graphed engine differs from "
                               "the eager runner")
    chunk = cfg.power_check_every
    for i, t in enumerate(tensors):
        one = msc_sequential(t, cfg, device=DEVICE)
        hold(torch, checks, f"{label} req {i} (m={t.shape[0]})", got[i], one,
             "msc_sequential", chunk)
    # warm times per bucket, in turns: graphed, eager, looped, twice
    for m, idx in groups.items():
        reqs = [tensors[i] for i in idx]
        t = {"graphed": [], "eager": [], "looped B=1": []}
        for _ in range(2):
            t["graphed"].append(_timed_s(torch, lambda: engine.run(reqs))[1])
            t["eager"].append(_timed_s(torch, lambda: eager((m,)))[1])
            t["looped B=1"].append(_timed_s(torch, lambda: loop.run(reqs))[1])
        g = min(t["graphed"])
        log(f"  warm m={m}, {len(idx)} requests in one dispatch: "
            + ", ".join(f"{k} {' / '.join(f'{x * 1e3:.2f}' for x in v)} ms "
                        f"({min(v) / g:.2f}x)" for k, v in t.items()))
    static, pools = engine.memory_reckoning()
    log(f"  {engine.graphs} graphs, static buffers {static} B, graph pools "
        f"{pools} B; launches of one warm run {counts}")
    loop.close()
    engine.close()
    STASH["static"] = {"tensors": tensors, "results": got, "cfg": cfg,
                       "label": label}
    return {label: counts}


# continuous serving: the skewed mix of benchmarks/msc_continuous.py (every
# 8th request near-noise, gamma = 2, the rest gamma = 300) at m = 200, the
# low end of paper Fig. 6, under that benchmark's gate (tol 3e-3, a probe
# every 8 sweeps, cap 240); 32 requests through 8 slots
CONT_M, CONT_N, CONT_B, CONT_SLOW_EVERY = 200, 32, 8, 8
CONT_GAMMA_SLOW, CONT_GAMMA_FAST = 2.0, 300.0
# MSCContinuousEngine's CUDA graphs per bucket: the chunk step and the refill
GRAPHS_PER_CONT_BUCKET = 2


class NoSyncInReplays:
    """While active, every replay of a captured step (`graphs.Step`) runs
    under `torch.cuda.set_sync_debug_mode("error")`: a host sync inside
    raises.  `calls` counts the replays."""

    def __init__(self, torch):
        from repro_torch.serving import graphs

        self.torch, self.cls, self.calls = torch, graphs.Step, 0
        self.orig = graphs.Step.__call__

    def __enter__(self):
        guard, orig = self, self.orig

        def guarded(step):
            guard.calls += 1
            guard.torch.cuda.set_sync_debug_mode("error")
            try:
                return orig(step)
            finally:
                guard.torch.cuda.set_sync_debug_mode("default")

        self.cls.__call__ = guarded
        return self

    def __exit__(self, *exc):
        self.cls.__call__ = self.orig


def _same_requests(a, b, d_tol=None):
    """Masks and sweeps identical per request and mode (and d within
    d_tol of the largest entry, when given)."""
    for x, y in zip(a, b):
        for j in range(3):
            if not (x[j].mask.cpu().equal(y[j].mask.cpu())
                    and int(x[j].power_iters_run) == int(
                        y[j].power_iters_run)):
                return False
            if d_tol is not None:
                dx, dy = x[j].d.cpu().double(), y[j].d.cpu().double()
                if (dx - dy).abs().max() > d_tol * dy.abs().max():
                    return False
    return True


def phase_continuous(torch, checks, smi):
    """msc_serve --continuous at the reference's defaults, then the
    continuous engine on the skewed mix, held to itself across three
    interleavings, to the graphed static engine and to msc_sequential.
    Returns {label: launch counts} of the engine's warm run."""
    from collections import Counter

    import numpy as np

    from repro_torch.core import (MSCConfig, PlantedSpec, make_planted_tensor,
                                  msc_sequential)
    from repro_torch.launch import msc_serve
    from repro_torch.serving import MSCContinuousEngine, MSCServeEngine

    log("continuous serving: msc_serve --continuous at the reference's "
        "defaults")
    with NoSyncInReplays(torch) as guard:
        res = msc_serve.run(msc_serve.parse_args(["--device", DEVICE,
                                                  "--continuous"]))
    cont, nb = res["continuous"], len(res["buckets"])
    want = GRAPHS_PER_CONT_BUCKET * nb
    ok = (len(cont["results"]) == 9 and cont["engine"].graphs == want
          and cont["stats_warmup"].compiles == want
          and cont["stats_stream"].compiles == 0)
    log(f"  {'ok  ' if ok else 'FAIL'} 9 results; CUDA graphs captured "
        f"{cont['stats_warmup'].compiles} warming up (want {want}: "
        f"{GRAPHS_PER_CONT_BUCKET} x {nb} buckets), "
        f"{cont['stats_stream'].compiles} in the stream; {guard.calls} "
        "replays with no host sync")
    if not ok:
        checks.failures.append("msc_serve --continuous: results or graph "
                               "counts off")
    cont["engine"].close()
    res["engine"].close()
    del res, cont

    label = (f"continuous serving kernels fp32 m={CONT_M} B={CONT_B}")
    log(f"{label}: {CONT_N} planted requests, every {CONT_SLOW_EVERY}th "
        f"gamma={CONT_GAMMA_SLOW:g}, the rest gamma={CONT_GAMMA_FAST:g}")
    cfg = MSCConfig(epsilon=3e-4, power_tol=3e-3, power_iters=240,
                    power_check_every=8, use_kernels=True)
    chunk = cfg.power_check_every
    tensors = [make_planted_tensor(
        torch.Generator(device=DEVICE).manual_seed(SEED + i),
        PlantedSpec.paper(CONT_M, CONT_GAMMA_SLOW if i % CONT_SLOW_EVERY == 0
                          else CONT_GAMMA_FAST)) for i in range(CONT_N)]
    static = MSCServeEngine(cfg, max_batch=CONT_B, device=DEVICE)
    res_s = static.run(tensors)  # cold: its captures
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = MSCContinuousEngine(cfg, slots=CONT_B, device=DEVICE)
    with NoSyncInReplays(torch) as guard:
        res_c = eng.run(tensors)  # cold: its captures
        cold = eng.stats
        ok = cold.compiles == eng.graphs == GRAPHS_PER_CONT_BUCKET
        # three interleavings: arrival order x placement x refill batching
        rng = np.random.RandomState(0)
        for placement, rmf in (("stable", 1), ("compact", 2),
                               ("compact", 4)):
            order = rng.permutation(CONT_N)
            eng.placement, eng.refill_min_free = placement, rmf
            got = eng.run([tensors[i] for i in order])
            same = _same_requests(got, [res_c[i] for i in order])
            log(f"  {'ok  ' if same else 'FAIL'} interleaving "
                f"({placement}, refill_min_free={rmf}): masks and sweeps "
                "as the first run's")
            if not same:
                checks.failures.append(f"{label}: results depend on the "
                                       f"interleaving ({placement}, {rmf})")
        eng.placement, eng.refill_min_free = "compact", 1
        mods = counters()
        for mod in mods.values():
            mod.launches = 0
        before = eng.stats
        res_w = eng.run(tensors)
        warm = eng.stats.delta(before)
        counts = {n: mod.launches for n, mod in mods.items()}
    held = torch.cuda.memory_allocated() - base
    # warm: the three interleavings and the last run capture nothing
    warm_captures = eng.stats.compiles - cold.compiles
    ok = ok and warm_captures == 0 and eng.graphs == GRAPHS_PER_CONT_BUCKET
    log(f"  {'ok  ' if ok else 'FAIL'} CUDA graphs captured {cold.compiles} "
        f"cold (want {GRAPHS_PER_CONT_BUCKET}), {warm_captures} in four warm "
        f"runs; {guard.calls} replays with no host sync")
    if not ok:
        checks.failures.append(f"{label}: {cold.compiles} graphs captured "
                               f"cold, {warm_captures} warm")
    want_launch = {"power_iter": 3 * eng._plan.chunks_per_step
                   * warm.chunk_steps, "abs_rowsum": 3 * warm.refills}
    ok = all(counts[n] == w for n, w in want_launch.items()) and not (
        counts["batched_gram"] or counts["flash_attention"])
    log(f"  {'ok  ' if ok else 'FAIL'} launches of the warm run {counts}; "
        f"want {want_launch} (3 x {warm.chunk_steps} step replays, 3 x "
        f"{warm.refills} refill replays)")
    if not ok:
        checks.failures.append(f"{label}: launches {counts}, want "
                               f"{want_launch}")
    same = _same_requests(res_w, res_c) and _same_requests(res_c, res_s,
                                                           d_tol=3e-5)
    log(f"  {'ok  ' if same else 'FAIL'} every request's masks and sweeps "
        "equal the graphed static engine's (B=8), d within 3e-5")
    if not same:
        checks.failures.append(f"{label}: differs from the static engine")
    for i in (0, 1, CONT_SLOW_EVERY + 1):
        hold(torch, checks, f"{label} req {i}", res_c[i],
             msc_sequential(tensors[i], cfg, device=DEVICE),
             "msc_sequential", chunk)

    # warm walls in turns: continuous, static, static, continuous
    t = {"continuous": [], "static": []}
    for name in ("continuous", "static", "static", "continuous"):
        e = eng if name == "continuous" else static
        t[name].append(_timed_s(torch, lambda: e.run(tensors))[1])
    c_s, s_s = min(t["continuous"]), min(t["static"])
    sweeps = Counter(max(int(r[j].power_iters_run) for j in range(3))
                     for r in res_c)
    log(f"  warm {CONT_N} requests: continuous "
        f"{' / '.join(f'{x * 1e3:.2f}' for x in t['continuous'])} ms, "
        f"static B={CONT_B} {' / '.join(f'{x * 1e3:.2f}' for x in t['static'])}"
        f" ms; static / continuous {s_s / c_s:.3f}x ({smi})")
    log(f"  warm run: occupancy {warm.occupancy:.3f} "
        f"({warm.busy_slot_chunks}/{warm.slot_chunks} slot-chunks), "
        f"{warm.chunk_steps} chunk steps, {warm.refills} refills, "
        f"{warm.evictions} evictions, queue wait p50 "
        f"{eng.stats.queue_wait_p50_chunks:.1f} / p99 "
        f"{eng.stats.queue_wait_p99_chunks:.1f} chunks; max-mode sweeps per "
        f"request {dict(sorted(sweeps.items()))}")
    static_b, pools = eng.memory_reckoning()
    eng.close()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - base
    ok = held <= static_b + pools and left == 0
    log(f"  {'ok  ' if ok else 'FAIL'} device memory held by the live "
        f"engine {held} B, reckoned {static_b} B static + {pools} B graph "
        f"pools; left once closed {left} B")
    if not ok:
        checks.failures.append(f"{label}: holds {held} B > {static_b} + "
                               f"{pools} B, or {left} B left once closed")
    static.close()
    STASH["continuous"] = {"tensors": tensors, "results": res_c, "cfg": cfg,
                           "label": label, "warm_ms": c_s * 1e3}
    return {label: counts}


def _flash_work(torch, b, sq, skv, d, elt, kw):
    """(bytes, flops) of one flash_attention call: q, k, v read once and o
    written once; 4·d flops per (query, key) pair the masks keep."""
    qpos = torch.arange(sq)[:, None] + kw.get("q_offset", 0)
    kpos = torch.arange(skv)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool)
    if kw.get("causal", True):
        keep &= kpos <= qpos
    if kw.get("window") is not None:
        keep &= kpos > qpos - kw["window"]
    pairs = int(keep.sum()) * b
    return (2 * b * sq * d + 2 * b * skv * d) * elt, 4 * d * pairs


def _plain_flash(torch, q, k, v, kw, group):
    """The plain version over `group` rows of b at a time (the gemma2
    shape's fp32 scores are 8.6 GB at once)."""
    from repro_torch.kernels import ref

    return torch.cat([ref.flash_attention(q[i:i + group], k[i:i + group],
                                          v[i:i + group], **kw)
                      for i in range(0, q.shape[0], group)])


# whisper-tiny at the serving phase's batch: 16 sequences x 6 heads
LM_B, LM_PROMPT, LM_GEN = 16, 32, 16
LM_RUN = "lm serve whisper-tiny pallas"
SHORT = {"float32": "fp32", "bfloat16": "bf16"}

# (label, b, sq, skv, d, options, timed, rows of b per plain call): the
# LM path's three calls (b = 16 sequences x 6 heads, 1500 frames),
# gemma2-27b's attention, and small ragged cases
FLASH_CASES = [
    ("whisper encoder self", LM_B * 6, 1500, 1500, 64, dict(causal=False),
     True, LM_B * 6),
    ("whisper prefill cross", LM_B * 6, LM_PROMPT, 1500, 64,
     dict(causal=False), True, LM_B * 6),
    ("whisper decode cross", LM_B * 6, 1, 1500, 64, dict(causal=False),
     True, LM_B * 6),
    ("gemma2-27b global", 32, 8192, 8192, 128,
     dict(causal=True, softcap=50.0), True, 4),
    ("gemma2-27b local", 32, 8192, 8192, 128,
     dict(causal=True, softcap=50.0, window=4096), True, 4),
    ("ragged q_offset", 5, 70, 133, 32, dict(causal=True, q_offset=63),
     False, 5),
    ("ragged window", 3, 100, 300, 128,
     dict(causal=True, q_offset=200, window=77, softcap=30.0), False, 3),
    ("ragged decode", 7, 1, 100, 256, dict(causal=True, q_offset=99),
     False, 7),
]


def flash_edge_cases(small):
    """Cases at the routes' boundaries and the tiles' edges: sq on both
    sides of the small-sq route's limit `small` and past one 64-row tile,
    skv of one key and on both sides of a 64-key tile, d = 256 causal at
    sq = skv = 300 and a window at d = 32 (same tuple form as
    FLASH_CASES)."""
    return [
        ("sq 2", 6, 2, 63, 64, dict(causal=False), False, 6),
        (f"sq = SQ_SMALL = {small}", 6, small, 65, 128,
         dict(causal=True, q_offset=60), False, 6),
        (f"sq = SQ_SMALL + 1 = {small + 1}", 6, small + 1, 65, 64,
         dict(causal=True, q_offset=60), False, 6),
        ("sq 65, one key", 6, 65, 1, 32, dict(causal=False), False, 6),
        ("sq 65, skv 63", 6, 65, 63, 64, dict(causal=True, q_offset=10),
         False, 6),
        ("sq 65, skv 65", 6, 65, 65, 128, dict(causal=False), False, 6),
        ("causal d=256", 4, 300, 300, 256, dict(causal=True), False, 4),
        ("window d=32", 4, 300, 300, 32, dict(causal=True, window=50), False,
         4),
    ]


# the share of bf16 outputs at the whisper encoder shape that may differ
# from the plain version's bf16 outputs: summing in another order moves
# few of them across a bf16 rounding boundary; a P rounded once to bf16
# before P·V (an error above 1e-4 of max |o|, tests/test_torch_flash.py)
# moves a large share
BF16_MISMATCH_MAX = 0.01


def flash_routes(torch, kfa, gen):
    """Both routes of each dtype timed at the whisper cross shape (96 ·
    sq rows over 1500 keys, d = 64) for sq = 1, 2, 4, 8, 16, 32: the
    evidence for SQ_SMALL.  Returns {"dtype sq=n": {"small": ms, "tile": ms}}."""
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        name = SHORT[str(dt).split(".")[-1]]
        k, v = (torch.randn((LM_B * 6, 1500, 64), generator=gen,
                            device=DEVICE).to(dt) for _ in range(2))
        for sq in (1, 2, 4, 8, 16, 32):
            q = torch.randn((LM_B * 6, sq, 64), generator=gen,
                            device=DEVICE).to(dt)
            t = out[f"{name} sq={sq}"] = {}
            for r in ("small", "tile"):
                def call():
                    return kfa.flash_attention(q, k, v, causal=False, route=r)
                t[r] = cuda_ms(torch, call, 20)
                t[r + "_device"] = graph_ms(torch, call, 20)
            log(f"  route times {name} q (96, {sq}, 64) kv (96, 1500, 64): "
                f"small-sq {t['small']:.4f} ms (device "
                f"{fmt_ms(t['small_device'])}), tile {t['tile']:.4f} ms "
                f"(device {fmt_ms(t['tile_device'])})")
    return out


def phase_flash(torch, checks):
    """flash_attention against its plain version at the LM path's shapes,
    gemma2-27b's and the routes' edges, then its times."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kfa

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)
    # fp32 output: sums in another order; bf16 output: an fp32 value on
    # the other side of a bf16 rounding boundary moves by 2^-8
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
    small = kfa.sq_small()
    log("flash_attention against its plain version (tolerance relative to "
        "the largest |plain| entry: 1e-5 for fp32, 1e-2 for bf16 outputs); "
        f"SQ_SMALL = {small}")
    rows, shapes = {}, {}
    for label, b, sq, skv, d, kw, timed, group in (FLASH_CASES +
                                                   flash_edge_cases(small)):
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[-1]
            q = torch.randn((b, sq, d), generator=gen, device=dev).to(dt)
            k = torch.randn((b, skv, d), generator=gen, device=dev).to(dt)
            v = torch.randn((b, skv, d), generator=gen, device=dev).to(dt)
            got = kfa.flash_attention(q, k, v, **kw)
            want = _plain_flash(torch, q, k, v, kw, group)
            checks.compare("flash_attention", f"flash_attention {name} "
                           f"{label} q {tuple(q.shape)} kv {tuple(k.shape)} "
                           f"{kw}", (got.float(),), (want.float(),),
                           tol[dt])
            if label == "whisper encoder self" and dt == torch.bfloat16:
                # a P rounded to bf16 before P·V moves a large share
                share = (got != want).float().mean().item()
                ok = share <= BF16_MISMATCH_MAX
                log(f"  {'ok  ' if ok else 'FAIL'} bf16 outputs that differ "
                    f"from the plain version's: {share:.4%} (at most "
                    f"{BF16_MISMATCH_MAX:.0%})")
                if not ok:
                    checks.failures.append(
                        f"flash_attention bf16 {label}: {share:.4%} of the "
                        f"outputs differ from the plain version's")
            del got, want
            if not timed:
                continue
            n_bytes, flops = _flash_work(torch, b, sq, skv, d,
                                         q.element_size(), kw)
            bms, by = bound_ms(n_bytes, flops, name)
            reps = 3 if sq > 4096 else 20
            row = {
                "ms": cuda_ms(torch, lambda: kfa.flash_attention(
                    q, k, v, **kw), reps),
                "device_ms": graph_ms(torch, lambda: kfa.flash_attention(
                    q, k, v, **kw), reps),
                "plain_ms": cuda_ms(torch, lambda: _plain_flash(
                    torch, q, k, v, kw, group), 3, 1),
                "bound_ms": bms, "bound_by": by, "library_ms": None,
                "shape": f"q {tuple(q.shape)} kv {tuple(k.shape)} {kw}",
            }
            if "softcap" not in kw and "window" not in kw:
                # the same function (no mask but causality, no cap) as
                # one library call; its flash path rounds P to the input
                # dtype, so it is a yardstick and no oracle
                causal = kw.get("causal", True)
                row["library_ms"] = cuda_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q[:, None], k[:, None], v[:, None],
                        is_causal=causal), reps)
            lib = ("n/a (no library call takes a softcap)"
                   if row["library_ms"] is None
                   else f"{row['library_ms']:.4f} ms")
            log(f"  time flash_attention {name} {label}: kernel "
                f"{row['ms']:.4f} ms (device time from a CUDA graph "
                f"{fmt_ms(row['device_ms'])}), plain {row['plain_ms']:.4f} ms, "
                f"library (F.scaled_dot_product_attention) {lib}, bound "
                f"{bms:.4f} ms ({by}: {n_bytes / 1e6:.1f} MB, "
                f"{flops:.3e} flops)")
            shapes[f"{label} {name}"] = row
            if label == "whisper encoder self":
                rows[("flash_attention", name)] = row
            del q, k, v
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    rows[("flash_attention", "shapes")] = shapes
    rows[("flash_attention", "routes")] = flash_routes(torch, kfa, gen)
    torch.cuda.empty_cache()
    return rows


def drive_lm(torch, label, argv):
    """One `serve` run with every launch count set to 0 just before it
    and read just after.  Returns (what run() returned, counts)."""
    from repro_torch.launch import serve

    log(f"LM serving: {label}")
    mods = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    out = serve.run(serve.parse_args(argv))
    counts = {n: mod.launches for n, mod in mods.items()}
    tm = out["timings"]
    log(f"  wall {out['seconds']:.3f} s, prefill {tm['prefill_ms']:.3f} ms "
        f"(encoder, prompt and first token), decode "
        f"{tm['decode_ms'] / LM_GEN:.3f} ms per token "
        f"({LM_B * LM_GEN / tm['decode_ms'] * 1e3:.1f} tok/s in decode, "
        f"{LM_B * LM_GEN / out['seconds']:.1f} tok/s over the whole "
        f"request), max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, launches "
        f"{counts}")
    return out, counts


def teacher_forced(torch, model, params, batch, tokens,
                   max_len=LM_PROMPT + LM_GEN):
    """Prefill and per-step logits of `model` fed `tokens` (B, n)."""
    logits, cache = model.prefill(params, batch, max_len=max_len)
    out = [logits]
    for i in range(tokens.shape[1]):
        logits, cache = model.decode_step(params, tokens[:, i:i + 1], cache,
                                          LM_PROMPT + i)
        out.append(logits)
    return out


def eager_decode(torch, model, params, batch, n, max_len):
    """Greedy decode as the engine ran it before its step was captured: n
    eager `decode_step` calls with an int cache_len.  Returns (tokens
    (B, n), decode ms per token by CUDA events)."""
    logits, cache = model.prefill(params, batch, max_len=max_len)
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    s = batch["tokens"].shape[1]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    outs = []
    for i in range(n):
        outs.append(tok)
        logits, cache = model.decode_step(params, tok, cache, s + i)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    end.record()
    end.synchronize()
    return torch.cat(outs, dim=1), start.elapsed_time(end) / n


def graphed_decode(torch, checks, model, params, batch, cdt, tol):
    """The engine's captured decode step against the eager loop on the
    same model, weights and prompt: fp32 tokens identical, the last
    step's logits within `tol` of the eager ones fed the same tokens, no
    host sync in the replays; decode ms per token of both."""
    from repro_torch.serving.engine import ServeEngine

    max_len = LM_PROMPT + 2 * LM_GEN  # room for LM_GEN more replays
    engine = ServeEngine(model, params, LM_B, max_len)
    engine.generate(batch, LM_GEN)  # cold: one eager step, the capture
    toks = engine.generate(batch, LM_GEN)  # warm: replays only
    g_ms = engine.timings["decode_ms"] / LM_GEN
    last = engine.logits.clone()
    try:
        torch.cuda.set_sync_debug_mode("error")
        for _ in range(LM_GEN):
            engine._decode()
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        synced = False
    except RuntimeError as e:
        torch.cuda.set_sync_debug_mode("default")
        synced = str(e).splitlines()[0]
    eager_decode(torch, model, params, batch, LM_GEN, max_len)  # warm-up
    e_toks, e_ms = eager_decode(torch, model, params, batch, LM_GEN, max_len)
    want = teacher_forced(torch, model, params, batch, toks, max_len)[-1]
    rel = ((last - want).abs().max() / want.abs().max()).item()
    same = torch.equal(toks, e_toks)
    ok = (rel <= tol and not synced and engine.captures == 1
          and (same or cdt != "float32"))
    log(f"  {'ok  ' if ok else 'FAIL'} {cdt} decode from one CUDA graph per "
        f"step: {g_ms:.3f} ms per token (eager loop {e_ms:.3f} ms, "
        f"{e_ms / g_ms:.2f}x); tokens == eager loop's {same}; last logits "
        f"rel diff {rel:.3e} (tol {tol:g}); host sync in {LM_GEN} replays: "
        f"{synced or 'none'}")
    if not ok:
        checks.failures.append(f"graphed decode {cdt}: tokens same {same}, "
                               f"logits rel {rel:.3e}, sync {synced}")
    return {"graphed_ms_per_token": g_ms, "eager_ms_per_token": e_ms}


def phase_lm(torch, checks, smi):
    """whisper-tiny served through the kernel route: launch counts, times
    (on the card `smi`), and the kernel route held to the plain route."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.inputs import make_batch
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServeEngine

    base = ["--arch", "whisper-tiny", "--batch", str(LM_B), "--prompt-len",
            str(LM_PROMPT), "--gen", str(LM_GEN), "--device", DEVICE]
    cfg = get_config("whisper-tiny")
    want = cfg.n_enc_layers + cfg.n_layers + cfg.n_layers * LM_GEN
    launches = {}
    log(f"  card: {smi}")
    for label, impl in ((LM_RUN, "pallas"), (LM_RUN + " (warm)", "pallas"),
                        ("lm serve whisper-tiny chunked (plain)", "chunked")):
        out, counts = drive_lm(torch, label, base + ["--attn-impl", impl])
        launches[label] = counts
        STASH.setdefault("lm", {})[label] = out["timings"] | {
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
        n = counts["flash_attention"]
        expect = want if impl == "pallas" else 0
        if n != expect:
            checks.failures.append(f"{label}: flash_attention launched {n} "
                                   f"times, not {expect}")
        for other in KERNELS:
            if other != "flash_attention" and counts[other]:
                checks.failures.append(f"{label}: {other} ran off its path")
        if tuple(out["tokens"].shape) != (LM_B, LM_GEN):
            checks.failures.append(f"{label}: tokens {out['tokens'].shape}")
    log(f"  flash_attention launches per request: {want} "
        f"({cfg.n_enc_layers} encoder self-attention + {cfg.n_layers} "
        f"prefill cross-attention + {cfg.n_layers} x {LM_GEN} decode "
        "cross-attention)")

    # the kernel route against the plain route on the same weights:
    # teacher forcing feeds both the plain route's greedy tokens.  fp32:
    # sums in another order, 1e-4 of max |logit|; bf16: an activation on
    # the other side of a bf16 rounding boundary moves by 2^-8 and eight
    # blocks carry it on, 2e-2 of max |logit|
    dev = torch.device(DEVICE)
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(0))
    tol = {"bfloat16": 2e-2, "float32": 1e-4}
    for cdt in ("bfloat16", "float32"):
        plain = build_model(dataclasses.replace(cfg, compute_dtype=cdt,
                                                attn_impl="chunked"))
        kern = build_model(dataclasses.replace(cfg, compute_dtype=cdt,
                                               attn_impl="pallas"))
        batch = make_batch(plain.cfg, LM_B, LM_PROMPT, kind="serve",
                           device=dev)
        engine = ServeEngine(plain, params, LM_B, LM_PROMPT + LM_GEN)
        toks = engine.generate(batch, LM_GEN)
        want_l = teacher_forced(torch, plain, params, batch, toks)
        got_l = teacher_forced(torch, kern, params, batch, toks)
        worst = 0.0
        for i, (g, w) in enumerate(zip(got_l, want_l)):
            rel = ((g - w).abs().max() / w.abs().max()).item()
            worst = max(worst, rel)
            if not bool(torch.isfinite(g).all()) or rel > tol[cdt]:
                checks.failures.append(
                    f"teacher forcing {cdt} step {i}: logits rel diff "
                    f"{rel:.3e} > {tol[cdt]:g} or non-finite")
        log(f"  {'ok  ' if worst <= tol[cdt] else 'FAIL'} teacher forcing "
            f"{cdt}: prefill and {LM_GEN} decode steps, max |kernel - plain| "
            f"/ max |plain logit| = {worst:.3e} (tol {tol[cdt]:g})")
        if cdt == "bfloat16":
            # context for the bf16 tolerance: how far bf16 rounding alone
            # moves the plain route (plain bf16 against plain fp32, on the
            # same tokens and frames)
            fp32 = build_model(dataclasses.replace(
                cfg, compute_dtype="float32", attn_impl="chunked"))
            ref_l = teacher_forced(torch, fp32, params, {
                k: v.float() if v.is_floating_point() else v
                for k, v in batch.items()}, toks)
            floor = max(((w - r).abs().max() / r.abs().max()).item()
                        for w, r in zip(want_l, ref_l))
            log(f"       bf16 rounding alone: max |plain bf16 - plain fp32| "
                f"/ max |logit| = {floor:.3e}")
        graphed_decode(torch, checks, kern, params, batch, cdt, tol[cdt])
        if cdt == "float32":
            k_toks = ServeEngine(kern, params, LM_B,
                                 LM_PROMPT + LM_GEN).generate(batch, LM_GEN)
            STASH["lm_fp32_tokens"] = k_toks
            same = torch.equal(k_toks, toks)
            log(f"  {'ok  ' if same else 'FAIL'} fp32 greedy tokens, kernel "
                f"route == plain route: {same}")
            if not same:
                checks.failures.append("fp32 greedy tokens differ between "
                                       "the kernel and the plain route")
    return launches


# phase 8: the parallel schedules over a mesh of one rank under NCCL (one
# card: NCCL takes one rank per device).  (label, mesh shape, relayout,
# config changes, the phase-4 one-device run it is held to, whether bit
# for bit, the kernels it must launch)
MESH_RUNS = (
    ("mesh (1,) gspmd allgather fp32", (1,), "gspmd", {},
     "flat+kernels fp32", True, ("power_iter", "abs_rowsum")),
    ("mesh (1,) collective ring fp32", (1,), "collective",
     {"epilogue": "ring"}, "flat+kernels fp32", True,
     ("power_iter", "abs_rowsum")),
    ("mesh (1, 1) collective_stream allgather fp32", (1, 1),
     "collective_stream", {}, "flat+kernels fp32", False,
     ("power_iter", "abs_rowsum")),
    ("mesh (1, 1) gspmd gram fp32", (1, 1), "gspmd", {"matrix_free": False},
     "flat+kernels gram fp32", False, ("batched_gram", "abs_rowsum")),
    ("mesh (1,) gspmd bf16_fp32", (1,), "gspmd",
     {"precision": "bf16_fp32"}, "flat+kernels bf16_fp32", True,
     ("power_iter", "abs_rowsum")),
)
MESH_D_TOL = 3e-5  # d of the inner-dim runs, relative to max d


def phase_mesh(torch, checks, singles, solve_ms, smi):
    """The paper's size (phase 4's tensor) through `build_msc_parallel`
    over DeviceMeshes of one NCCL rank: each run held to phase 4's
    one-device run of its config, its kernels launched, no host read in
    an extraction, 0 B left once the group and the tensors are freed.
    The process group is torn down whether the phase passes or fails."""
    import gc
    import tempfile

    from repro_torch.core import PlantedSpec, make_planted_tensor
    from repro_torch.launch.mesh import join, leave, make_msc_mesh

    log(f"mesh path: one NCCL rank, m = {M}; card: {smi}")
    chunk = main_cfg().power_check_every
    launches = {}
    gc.collect()  # what the earlier phases left to the collector
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        try:
            dev = join("cuda", rank=0, world_size=1,
                       store_file=os.path.join(tmp, "store"))
            log(f"  NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, "
                f"rank 0 of 1 on {dev}")
            tensor = make_planted_tensor(
                torch.Generator(device=dev).manual_seed(SEED),
                PlantedSpec.paper(M, GAMMA))
            for label, shape, relayout, change, single, exact, want in \
                    MESH_RUNS:
                launches[label] = _mesh_run(
                    torch, checks, label, make_msc_mesh("flat", shape),
                    relayout, main_cfg().with_(use_kernels=True, **change),
                    tensor, singles[single], single, solve_ms[single], exact,
                    want, chunk)
            del tensor
        finally:
            leave()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - base
    log(f"  device memory left once the process group and the tensors are "
        f"freed: {left} B")
    if left:
        checks.failures.append(f"mesh path: {left} B left allocated")
    return launches


def _mesh_run(torch, checks, label, mesh, relayout, cfg, tensor, one,
              one_label, one_ms, exact, want, chunk):
    """One mesh config: a cold run, then a warm one with the launch counts
    set to 0 just before it and read just after, timed between two warm
    one-device solves of the same config.  Returns the counts."""
    from repro_torch.core import build_msc_parallel

    log(f"mesh path: {label}")
    run = build_msc_parallel(cfg, "flat", mesh=mesh, relayout=relayout)
    single = build_msc_parallel(cfg, "flat", device=tensor.device)
    run(tensor)
    _, t_one = _timed_s(torch, lambda: single(tensor))
    mods = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    with NoHostReadsInExtraction(torch) as guard:
        res, t = _timed_s(torch, lambda: run(tensor))
    counts = {n: mod.launches for n, mod in mods.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    _, t_one2 = _timed_s(torch, lambda: single(tensor))
    log(f"  warm solve {t * 1e3:.1f} ms; one device in turns "
        f"{t_one * 1e3:.1f} / {t_one2 * 1e3:.1f} ms (phase 4, "
        f"{one_label}: {one_ms:.1f} ms); peak {peak:.2f} GiB, launches "
        f"{counts}, {guard.calls} extractions with no host read")
    if guard.calls != 3:
        checks.failures.append(f"{label}: {guard.calls} extractions, not 3")
    for n in KERNELS:
        if n in want and counts[n] == 0:
            checks.failures.append(f"{label}: {n} never launched")
        if n not in want and counts[n]:
            checks.failures.append(f"{label}: {n} ran off its path")
    if exact:
        for j in range(3):
            same = (torch.equal(res[j].mask, one[j].mask)
                    and torch.equal(res[j].d, one[j].d)
                    and torch.equal(res[j].lambdas, one[j].lambdas)
                    and int(res[j].power_iters_run)
                    == int(one[j].power_iters_run))
            log(f"  {'ok  ' if same else 'FAIL'} mode {j}: masks, d, λ and "
                f"sweeps ({int(res[j].power_iters_run)}) bit-identical to "
                f"the one-device run: {same}")
            if not same:
                checks.failures.append(f"{label} mode {j}: not the "
                                       "one-device run's bits")
    else:
        hold(torch, checks, label, res, one, "one-device run", chunk)
        for j in range(3):
            rel = ((res[j].d - one[j].d).abs().max()
                   / one[j].d.abs().max()).item()
            if not rel <= MESH_D_TOL:
                checks.failures.append(f"{label} mode {j}: d rel diff "
                                       f"{rel:.3e} > {MESH_D_TOL:g}")
    del res
    return counts


# phase 9: the MSC serving engines over a mesh of one NCCL rank; each
# engine's CUDA graphs per bucket hold the bucket's collectives
# (mesh shape, relayout) of the static engine's runs: every relayout on
# both shapes (the collective ones make all three blocks in mode 1's
# head, inside its graph)
MESH_SERVE_RUNS = tuple((shape, relayout) for relayout in
                        ("gspmd", "collective", "collective_stream")
                        for shape in ((1,), (1, 1)))


def _mesh_engine_run(torch, checks, label, make, tensors, one, exact,
                     per_bucket, buckets, one_engine):
    """One engine on a mesh: cold (its captures), then warm with the
    launch counts set to 0 just before and read just after, and no host
    sync in a replay; held to the one-device engine's results `one`
    (bits when `exact`, else masks and sweeps and d within 3e-5); warm
    walls of both engines in turns; 0 B left once closed.  Returns the
    counts."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = make()
    eng.run(tensors)
    cold = eng.stats.compiles
    mods = counters()
    for mod in mods.values():
        mod.launches = 0
    with NoSyncInReplays(torch) as guard:
        got = eng.run(tensors)
    counts = {n: mod.launches for n, mod in mods.items()}
    warm = eng.stats.compiles - cold
    ok = cold == per_bucket * buckets == eng.graphs and warm == 0
    log(f"  {'ok  ' if ok else 'FAIL'} {label}: CUDA graphs captured {cold} "
        f"cold (want {per_bucket} x {buckets} buckets, collectives inside), "
        f"{warm} warm; {guard.calls} replays with no host sync; launches "
        f"{counts}")
    if not ok:
        checks.failures.append(f"{label}: {cold} graphs cold, {warm} warm")
    for n in ("power_iter", "abs_rowsum"):
        if counts[n] == 0:
            checks.failures.append(f"{label}: {n} never launched")
    for n in ("batched_gram", "flash_attention"):
        if counts[n]:
            checks.failures.append(f"{label}: {n} ran off its path")
    if exact:
        same = all(torch.equal(g[j].mask, w[j].mask)
                   and torch.equal(g[j].d, w[j].d)
                   and torch.equal(g[j].lambdas, w[j].lambdas)
                   and g[j].power_iters_run == w[j].power_iters_run
                   for g, w in zip(got, one) for j in range(3))
        what = "masks, d, λ and sweeps bit-identical to"
    else:
        same = _same_requests(got, one, d_tol=3e-5)
        what = "masks and sweeps identical (d within 3e-5) to"
    log(f"  {'ok  ' if same else 'FAIL'} every request's {what} the "
        "one-device engine's")
    if not same:
        checks.failures.append(f"{label}: differs from the one-device "
                               "engine")
    t = {"mesh": [], "one device": []}
    for name in ("mesh", "one device", "one device", "mesh"):
        e = eng if name == "mesh" else one_engine
        t[name].append(_timed_s(torch, lambda: e.run(tensors))[1])
    log(f"  warm {len(tensors)} requests: mesh "
        f"{' / '.join(f'{x * 1e3:.2f}' for x in t['mesh'])} ms, one device "
        f"{' / '.join(f'{x * 1e3:.2f}' for x in t['one device'])} ms "
        f"(mesh / one device {min(t['mesh']) / min(t['one device']):.3f}x)")
    static, pools = eng.memory_reckoning()
    eng.close()
    del eng
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - base
    log(f"  {'ok  ' if left == 0 else 'FAIL'} static buffers {static} B, "
        f"graph pools {pools} B; left once closed {left} B")
    if left:
        checks.failures.append(f"{label}: {left} B left once closed")
    return counts


def phase_mesh_serving(torch, checks, singles, smi):
    """Phase 5b's static cells and phase 5c's skewed mix through the
    engines on meshes of one NCCL rank, then msc_serve --mesh-shape 1 and
    msc_run --batch 2 --mesh-shape 1 (the CLIs' mesh paths in this
    process's group).  Returns {label: launch counts}."""
    import gc
    import tempfile

    from repro_torch.launch import msc_run, msc_serve
    from repro_torch.launch.mesh import join, leave, make_msc_mesh
    from repro_torch.serving import MSCContinuousEngine, MSCServeEngine

    log(f"MSC serving on a mesh: one NCCL rank; card: {smi}")
    launches = {}
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    st, ct = STASH["static"], STASH["continuous"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        try:
            dev = join("cuda", rank=0, world_size=1,
                       store_file=os.path.join(tmp, "store"))
            one = MSCServeEngine(st["cfg"], max_batch=SERVE_B, device=dev)
            one.run(st["tensors"])
            for shape, relayout in MESH_SERVE_RUNS:
                mesh = make_msc_mesh("flat", shape)
                label = f"{st['label']} mesh {shape}" + (
                    f" {relayout}" if relayout != "gspmd" else "")
                launches[label] = _mesh_engine_run(
                    torch, checks, label,
                    lambda: MSCServeEngine(st["cfg"], max_batch=SERVE_B,
                                           mesh=mesh, relayout=relayout),
                    st["tensors"], st["results"], shape == (1,),
                    GRAPHS_PER_BUCKET, len(SERVE_SIZES), one)
            one.close()
            one = MSCContinuousEngine(ct["cfg"], slots=CONT_B, device=dev)
            one.run(ct["tensors"])
            mesh = make_msc_mesh("flat", (1,))
            label = f"{ct['label']} mesh (1,)"
            launches[label] = _mesh_engine_run(
                torch, checks, label,
                lambda: MSCContinuousEngine(ct["cfg"], slots=CONT_B,
                                            mesh=mesh),
                ct["tensors"], ct["results"], True, GRAPHS_PER_CONT_BUCKET,
                1, one)
            one.close()
            del one, mesh

            log("MSC serving on a mesh: msc_serve --mesh-shape 1 "
                "--continuous at the reference's defaults")
            with NoSyncInReplays(torch) as guard:
                res = msc_serve._serve(msc_serve.parse_args(
                    ["--device", DEVICE, "--mesh-shape", "1",
                     "--continuous"]), dev)
            nb, cont = len(res["buckets"]), res["continuous"]
            ok = (res["stats_cold"].compiles == GRAPHS_PER_BUCKET * nb
                  and res["stats_warm"].compiles == 0
                  and cont["stats_warmup"].compiles
                  == GRAPHS_PER_CONT_BUCKET * nb
                  and cont["stats_stream"].compiles == 0
                  and len(cont["results"]) == 9)
            log(f"  {'ok  ' if ok else 'FAIL'} static: "
                f"{res['stats_cold'].compiles} graphs cold, "
                f"{res['stats_warm'].compiles} warm; continuous: "
                f"{cont['stats_warmup'].compiles} warming up, "
                f"{cont['stats_stream'].compiles} in the stream; "
                f"{guard.calls} replays with no host sync")
            if not ok:
                checks.failures.append("msc_serve --mesh-shape 1: graph "
                                       "counts or results off")
            msc_serve._close(res)
            del res, cont

            label = "batch 2 flat+kernels fp32 mesh (1,)"
            one = singles["batch 2 flat+kernels fp32"]
            out, counts = drive(torch, label, [
                "--m", str(M), "--gamma", str(GAMMA), "--seed", str(SEED),
                "--device", DEVICE, "--kernels", "--batch", "2",
                "--mesh-shape", "1"], mesh_device=dev)
            launches[label] = counts
            cold, warm = out["stats_cold"], out["stats_warm"]
            same = all(torch.equal(g[j].mask, w[j].mask)
                       and torch.equal(g[j].d, w[j].d)
                       and g[j].power_iters_run == w[j].power_iters_run
                       for g, w in zip(out["results"], one["results"])
                       for j in range(3))
            ok = (same and cold.compiles == GRAPHS_PER_BUCKET
                  and warm.compiles == 0 and out["left"] == 0
                  and out["loop_left"] == 0
                  and counts["power_iter"] and counts["abs_rowsum"])
            log(f"  {'ok  ' if ok else 'FAIL'} masks, d and sweeps "
                f"bit-identical to phase 5's one-device --batch 2: {same}; "
                f"graphs {cold.compiles} cold / {warm.compiles} warm; warm "
                f"{out['warm'] * 1e3:.1f} ms (one device, phase 5: "
                f"{one['warm'] * 1e3:.1f} ms); left once closed "
                f"{out['left']} / {out['loop_left']} B")
            if not ok:
                checks.failures.append(f"{label}: bits, graph counts, "
                                       "kernels or memory off")
        finally:
            leave()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - base
    log(f"  device memory left once the process group is gone: {left} B")
    if left:
        checks.failures.append(f"mesh serving: {left} B left allocated")
    return launches


# phase 10: LM serving on a (data, model) = (1, 1) mesh of one NCCL rank
LM_MESH_RUN = "lm serve whisper-tiny pallas mesh (1, 1)"


def phase_mesh_lm(torch, checks, smi):
    """whisper-tiny at phase 7's size through `serve` on a (1, 1) mesh:
    72 flash_attention launches, its times beside phase 7's; then, per
    compute dtype, the mesh engine against the one-device engine on the
    same weights: fp32 tokens identical (and to phase 7's), teacher-forced
    logits within phase 7's tolerances, the decode step one CUDA graph
    with no host sync in its replays, 0 B left."""
    import dataclasses
    import gc
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.configs.inputs import make_batch
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import join, leave, make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServeEngine

    log(f"LM serving on a (data, model) = (1, 1) mesh: one NCCL rank; card: "
        f"{smi}")
    cfg = get_config("whisper-tiny")
    want = cfg.n_enc_layers + cfg.n_layers + cfg.n_layers * LM_GEN
    launches = {}
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    argv = ["--arch", "whisper-tiny", "--batch", str(LM_B), "--prompt-len",
            str(LM_PROMPT), "--gen", str(LM_GEN), "--device", DEVICE,
            "--attn-impl", "pallas", "--model-axis", "1"]
    tol = {"bfloat16": 2e-2, "float32": 1e-4}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
        try:
            dev = join("cuda", rank=0, world_size=1,
                       store_file=os.path.join(tmp, "store"))
            for label, ref in ((LM_MESH_RUN, LM_RUN),
                               (LM_MESH_RUN + " (warm)", LM_RUN + " (warm)")):
                log(f"LM serving: {label}")
                mods = counters()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for mod in mods.values():
                    mod.launches = 0
                out = serve._serve(serve.parse_args(argv), dev)
                counts = {n: mod.launches for n, mod in mods.items()}
                launches[label] = counts
                tm, p7 = out["timings"], STASH["lm"][ref]
                peak = torch.cuda.max_memory_allocated() / 2**20
                ok = (counts["flash_attention"] == want
                      and not any(counts[n] for n in KERNELS
                                  if n != "flash_attention")
                      and tuple(out["tokens"].shape) == (LM_B, LM_GEN)
                      and out["mesh"] == {"data": 1, "model": 1})
                log(f"  {'ok  ' if ok else 'FAIL'} mesh {out['mesh']}, "
                    f"launches {counts} (want {want} flash_attention); "
                    f"prefill {tm['prefill_ms']:.3f} ms (phase 7: "
                    f"{p7['prefill_ms']:.3f}), decode "
                    f"{tm['decode_ms'] / LM_GEN:.3f} ms per token (phase 7: "
                    f"{p7['decode_ms'] / LM_GEN:.3f}), max_memory_allocated "
                    f"{peak:.1f} MiB (phase 7: {p7['peak_mib']:.1f})")
                if not ok:
                    checks.failures.append(f"{label}: launches, tokens or "
                                           "mesh off")
                del out
            params = build_model(cfg).init(
                torch.Generator(device=dev).manual_seed(0))
            mesh = make_local_mesh(1)
            max_len = LM_PROMPT + 2 * LM_GEN
            for cdt in ("bfloat16", "float32"):
                model = build_model(dataclasses.replace(
                    cfg, compute_dtype=cdt, attn_impl="pallas"))
                batch = make_batch(model.cfg, LM_B, LM_PROMPT, kind="serve",
                                   device=dev)
                one = ServeEngine(model, params, LM_B, max_len)
                one.generate(batch, LM_GEN)  # cold: one eager step, capture
                toks = one.generate(batch, LM_GEN)
                eng = ServeEngine(model, params, LM_B, max_len, mesh=mesh)
                eng.generate(batch, LM_GEN)  # cold: one eager step, capture
                got = eng.generate(batch, LM_GEN)
                synced = False
                try:
                    torch.cuda.set_sync_debug_mode("error")
                    for _ in range(LM_GEN):
                        eng._decode()
                    torch.cuda.set_sync_debug_mode("default")
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    torch.cuda.set_sync_debug_mode("default")
                    synced = str(e).splitlines()[0]
                # teacher forcing: both fed the one-device engine's tokens
                want_l = teacher_forced(torch, model, params, batch, toks,
                                        max_len)
                logits, cache = eng._prefill_fn(eng.params,
                                                eng.local_batch(batch))
                got_l = [logits]
                for i in range(LM_GEN):
                    logits, cache = eng._decode_fn(
                        eng.params, toks[:, i:i + 1], cache, LM_PROMPT + i)
                    got_l.append(logits)
                worst = max(((g - w).abs().max() / w.abs().max()).item()
                            for g, w in zip(got_l, want_l))
                same = torch.equal(got, toks)
                p7 = (torch.equal(got, STASH["lm_fp32_tokens"])
                      if cdt == "float32" else True)
                ok = (worst <= tol[cdt] and not synced and eng.captures == 1
                      and (cdt != "float32" or (same and p7)))
                log(f"  {'ok  ' if ok else 'FAIL'} {cdt}: tokens == one "
                    f"device's {same} (== phase 7's fp32 tokens {p7}); "
                    f"teacher-forced logits max rel diff {worst:.3e} (tol "
                    f"{tol[cdt]:g}); decode graphs {eng.captures}, host "
                    f"sync in {LM_GEN} replays: {synced or 'none'}; warm "
                    f"prefill {eng.timings['prefill_ms']:.3f} ms (one device "
                    f"{one.timings['prefill_ms']:.3f}), decode "
                    f"{eng.timings['decode_ms'] / LM_GEN:.3f} ms per token "
                    f"(one device {one.timings['decode_ms'] / LM_GEN:.3f}), "
                    f"{smi}")
                if not ok:
                    checks.failures.append(f"{LM_MESH_RUN} {cdt}: tokens, "
                                           "logits, graphs or syncs off")
                del one, eng, got_l, want_l, logits, cache, got, toks, batch
                del model
            del params, mesh
        finally:
            leave()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - base
    log(f"  device memory left once the process group is gone: {left} B")
    if left:
        checks.failures.append(f"mesh LM serving: {left} B left allocated")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)

    checks = Checks()
    t_start = time.perf_counter()
    smi = phase_card(torch)
    phase_build()
    rows = phase_kernels(torch, checks)
    launches, singles, solve_ms = phase_main_path(torch, checks)
    launches.update(phase_batched(torch, checks, singles))
    launches.update(phase_static(torch, checks))
    launches.update(phase_continuous(torch, checks, smi))
    rows.update(phase_flash(torch, checks))
    launches.update(phase_lm(torch, checks, smi))
    launches.update(phase_mesh(torch, checks, singles, solve_ms, smi))
    launches.update(phase_mesh_serving(torch, checks, singles, smi))
    launches.update(phase_mesh_lm(torch, checks, smi))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if checks.failures:
        for f in checks.failures:
            print(f"FAIL {f}", file=sys.stderr)
        return 1

    # kernel: (source, TPU kernel it replaces, the main-path run whose
    # launch count is reported)
    source = {"power_iter": ("src/repro_torch/kernels/csrc/power_iter.cu",
                             "src/repro/kernels/power_iter.py:48",
                             "flat+kernels fp32"),
              "abs_rowsum": ("src/repro_torch/kernels/csrc/ring.cu",
                             "src/repro/kernels/ring.py:29",
                             "flat+kernels fp32"),
              "batched_gram": ("src/repro_torch/kernels/csrc/gram.cu",
                               "src/repro/kernels/gram.py:23",
                               "flat+kernels gram fp32")}
    source["flash_attention"] = (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:31", LM_RUN)
    kernels = []
    for name, (src, replaces, path) in source.items():
        # the row's own numbers are in the main path's dtype: fp32 for the
        # MSC kernels, the LM's bf16 compute for flash_attention (its row
        # carries the fp32 numbers and the other shapes beside them)
        main, other = (("bfloat16", "float32") if name == "flash_attention"
                       else ("float32", "bfloat16"))
        row = rows[(name, main)]
        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[path][name],
            "max_abs_err": checks.max_abs[name], "ms": row["ms"],
            "device_ms": row.get("device_ms"),
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "dtype": main, "shape": row.get("shape"),
            f"{SHORT[other]}_ms": rows[(name, other)]["ms"],
            f"{SHORT[other]}_bound_ms": rows[(name, other)]["bound_ms"],
            "launches_path": path,
            "launches_by_path": {k: v[name] for k, v in launches.items()
                                 if v[name]},
            "card": smi}
        if name != "flash_attention":
            entry["bf16_library_ms"] = rows[(name, other)]["library_ms"]
        if name == "power_iter":
            entry["sweep_bound_ms"] = row["sweep_bound_ms"]
            # "route" is the contract's (cuda); the kernel's own route
            # (what power_iter.route() picks at 1000³) goes here
            entry["kernel_route"] = {n: rows[(name, n)]["route"]
                                     for n in ("float32", "bfloat16")}
            entry["route_ms"] = {n: rows[(name, n)]["route_ms"]
                                 for n in ("float32", "bfloat16")}
            entry["waves"] = {n: rows[(name, n)]["waves"]
                              for n in ("float32", "bfloat16")}
            entry["bf16_sweep_bound_ms"] = rows[(name, other)][
                "sweep_bound_ms"]
        if name == "batched_gram":
            entry["bf16_library_rounded_ms"] = rows[(name, other)][
                "library_rounded_ms"]
        if name == "flash_attention":
            entry["fp32_plain_ms"] = rows[(name, other)]["plain_ms"]
            entry["fp32_library_ms"] = rows[(name, other)]["library_ms"]
            entry["other_shapes"] = rows[(name, "shapes")]
            entry["route_ms"] = rows[(name, "routes")]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
