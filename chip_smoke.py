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
   same function (timed here only; the port never calls it).
   `abs_rowsum` must also give the same bits in two calls.
4. The main path at the paper's size: `launch/msc_run.py` at m = 1000
   (the 4 GB fp32 tensor of Fig. 6), γ = 1000, seed 0, the CLI's
   default ε, with each eigensolver.  Matrix-free: flat+kernels in fp32
   and bf16_fp32, sequential+kernels in fp32, and the einsum path in
   fp32 as this run's oracle.  Explicit gram (`--gram`, paper Alg. 1):
   the same four runs, held to the gram einsum oracle and to the
   matrix-free oracle.  Requires identical fp32 masks, sweeps equal or
   one gate chunk apart, finite d, and every kernel of a path launched
   by its run (launch counts set to 0 just before each run and read
   just after); then one flat+kernels fp32 run per eigensolver at
   γ = 10000 must recover the planted cluster (rec=1.000).
5. Batched serving: `msc_run --batch 2 --kernels` at m = 1000, with
   and without `--gram` (MSCServeEngine, seeds 0 and 1 in one
   dispatch).  Each request must give the masks of the single-tensor
   flat run of its seed, with sweeps equal or one gate chunk apart; the
   engine must build 1 runner cold and 0 warm.  Prints the warm and
   looped-warm times, the speedup and the peak device memory.
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
   1e-4 in fp32, and identical greedy tokens in fp32.  Prints prefill
   ms, decode ms per token, tokens/s and the peak device memory.

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

    # ---- power_iter: slices (1000, 1000, 1000), the main path's mode slices
    b = r = c = M
    t32 = torch.randn((b, r, c), generator=gen, device=dev)
    v0 = torch.randn((b, c), generator=gen, device=dev)
    v0 /= v0.norm(dim=-1, keepdim=True)
    k = 6

    def chunk(label, s, v):
        # resid = ‖w − λv‖ is rounding noise on a converged slice: it is
        # held to the scale of λ
        plain = ref.power_iterate_chunk(s, v, k)
        checks.compare("power_iter", f"power_iterate_chunk k={k} {label}",
                       kpi.power_iterate_chunk(s, v, k), plain,
                       tol[s.dtype], [None, None, plain[1].abs().max().item()])

    for dt in (torch.float32, torch.bfloat16):
        s = t32.to(dt)
        name = str(dt).split(".")[-1]
        chunk(f"{name} {tuple(s.shape)}", s, v0)
        checks.compare("power_iter", f"power_iterate n=60+lambda {name} "
                       f"{tuple(s.shape)}", kpi.power_iterate(s, v0, 60),
                       ref.power_iterate(s, v0, 60), tol[dt])
        checks.compare("power_iter", f"power_matvec {name} {tuple(s.shape)}",
                       (kpi.power_matvec(s, v0),), (ref.power_matvec(s, v0),),
                       tol[dt])
        elt = s.element_size()
        n_bytes = b * r * c * elt + 2 * b * c * 4 + 2 * b * 4
        flops = 4 * b * r * c * k
        bms, by = bound_ms(n_bytes, flops, name)
        def library():  # two torch.bmm per sweep, operands in dtype dt
            v = v0.to(dt)
            for _ in range(k):
                tv = torch.bmm(s, v.unsqueeze(-1))
                v = torch.bmm(tv.transpose(1, 2), s).squeeze(1)
            return v

        row = {
            "ms": cuda_ms(torch, lambda: kpi.power_iterate_chunk(s, v0, k), 5),
            "plain_ms": cuda_ms(
                torch, lambda: ref.power_iterate_chunk(s, v0, k), 3, 1),
            "library_ms": cuda_ms(torch, library, 3, 1),
            "bound_ms": bms, "bound_by": by,
            "sweep_bound_ms": k * b * r * c * elt / HBM_BYTES_PER_S * 1e3,
        }
        rows[("power_iter", name)] = row
        log(f"  time power_iterate_chunk k={k} {name}: kernel "
            f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, library "
            f"(2 torch.bmm per sweep) {row['library_ms']:.3f} ms, bound "
            f"{bms:.3f} ms ({by}; T read once), streaming bound "
            f"{row['sweep_bound_ms']:.3f} ms (T read once per sweep)")
        del s
    del t32
    torch.cuda.empty_cache()

    # ragged: r and c not multiples of any tile, tile rows cut mid-slice
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((37, 1003, 301), generator=gen, device=dev).to(dt)
        v = torch.randn((37, 301), generator=gen, device=dev)
        v /= v.norm(dim=-1, keepdim=True)
        name = str(dt).split(".")[-1]
        chunk(f"{name} (37, 1003, 301)", x, v)
        checks.compare("power_iter", f"power_matvec {name} (37, 1003, 301)",
                       (kpi.power_matvec(x, v),), (ref.power_matvec(x, v),),
                       tol[dt])

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
    cases = [(M, M, M), (37, 1003, 301), (2, 300, 257, 131)]
    for shape in cases:
        x = torch.randn(shape, generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            s = x.to(dt)
            name = str(dt).split(".")[-1]
            for out in (None, torch.float32):
                got = ops.batched_gram(s, out_dtype=out)
                want = ref.batched_gram(s, out)
                checks.compare("batched_gram", f"batched_gram {name} "
                               f"{shape} out={str(got.dtype)[6:]}",
                               (got.float(),), (want.float(),),
                               tol[got.dtype])
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
                    "library_ms": cuda_ms(
                        torch, lambda: torch.bmm(s.mT, s), 3, 1),
                    "bound_ms": bms, "bound_by": by,
                }
                rows[("batched_gram", name)] = row
                log(f"  time batched_gram {name} {shape} -> fp32: kernel "
                    f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
                    f"library (torch.bmm(t.mT, t), result in {name}"
                    f"{', rounded' if name == 'bfloat16' else ''}) "
                    f"{row['library_ms']:.3f} ms, bound {bms:.3f} ms ({by})")
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


def drive(torch, label, argv):
    """One `msc_run` run with every launch count set to 0 just before it
    and read just after.  Returns (what run() returned, counts)."""
    from repro_torch.launch import msc_run

    log(f"main path: {label}")
    mods = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    t0 = time.perf_counter()
    out = msc_run.run(msc_run.parse_args(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: mod.launches for n, mod in mods.items()}
    log(f"  wall {wall:.2f} s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{counts}")
    return out, counts


def hold(torch, checks, label, res, oracle, oracle_name, chunk):
    """Masks identical to the oracle's; sweeps equal or one gate chunk
    apart.  Returns the modes whose sweeps differ."""
    diverged = []
    for j in range(3):
        same = torch.equal(res[j].mask.cpu(), oracle[j].mask.cpu())
        dd = ((res[j].d.cpu() - oracle[j].d.cpu()).abs().max()
              / oracle[j].d.abs().max().cpu()).item()
        log(f"  {label} mode {j}: mask == {oracle_name} {same}, d rel diff "
            f"{dd:.3e}, sweeps {res[j].power_iters_run} vs "
            f"{oracle[j].power_iters_run}")
        if not same:
            checks.failures.append(f"{label} mode {j}: mask differs from "
                                   f"{oracle_name}")
        gap = abs(res[j].power_iters_run - oracle[j].power_iters_run)
        if gap > chunk:
            checks.failures.append(f"{label} mode {j}: sweeps more than one "
                                   f"gate chunk from {oracle_name}")
        if gap:
            diverged.append(j)
    return diverged


def main_cfg():
    """The MSCConfig `msc_run` builds at m = M (its gate chunk too)."""
    from repro_torch.core import MSCConfig

    return MSCConfig(epsilon=0.5 / (M - M // 10) ** 2, max_extraction_iters=M)


def phase_main_path(torch, checks):
    """Both eigensolvers at m = 1000 through the CLI.  Returns
    ({label: counts}, {label: MSCResult})."""
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
    results, launches = {}, {}
    for label, extra, want in runs:
        out, counts = drive(torch, label, base + extra)
        rec = out[0]
        launches[label] = counts
        results[label] = rec["result"]
        log(f"  solve {rec['t']:.3f} s (the rest of the wall time is data "
            f"and the sim metric), rec={rec['rec']:.3f}")
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
    return launches, results


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
            f"{out['loop_warm'] / out['warm']:.2f}x, compiles "
            f"{cold.compiles} cold / {warm.compiles} warm (first dispatches "
            "of a bucket: bookkeeping, eager PyTorch compiles nothing)")
        # the engine returns host results and keeps no device state: a
        # run that leaves device memory allocated (a cached buffer, a gram
        # held by a closure) fails here
        if (out["kept_cold"], out["kept_warm"]) != (0, 0):
            checks.failures.append(
                f"{label}: device memory left allocated, {out['kept_cold']} B "
                f"by the cold run and {out['kept_warm']} B by the warm run")
        solve = "batched_gram" if flag else "power_iter"
        for n in (solve, "abs_rowsum"):
            if counts[n] == 0:
                checks.failures.append(f"{label}: {n} never launched")
        for i, res in enumerate(out["results"]):
            one = singles[f"flat+kernels {solver}fp32" + (" seed 1" if i
                                                          else "")]
            hold(torch, checks, f"{label} req {i}", res, one,
                 f"single-tensor run of seed {i}", chunk)
    return launches


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


def teacher_forced(torch, model, params, batch, tokens):
    """Prefill and per-step logits of `model` fed `tokens` (B, n)."""
    logits, cache = model.prefill(params, batch, max_len=LM_PROMPT + LM_GEN)
    out = [logits]
    for i in range(tokens.shape[1]):
        logits, cache = model.decode_step(params, tokens[:, i:i + 1], cache,
                                          LM_PROMPT + i)
        out.append(logits)
    return out


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
        if cdt == "float32":
            k_toks = ServeEngine(kern, params, LM_B,
                                 LM_PROMPT + LM_GEN).generate(batch, LM_GEN)
            same = torch.equal(k_toks, toks)
            log(f"  {'ok  ' if same else 'FAIL'} fp32 greedy tokens, kernel "
                f"route == plain route: {same}")
            if not same:
                checks.failures.append("fp32 greedy tokens differ between "
                                       "the kernel and the plain route")
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
    launches, singles = phase_main_path(torch, checks)
    launches.update(phase_batched(torch, checks, singles))
    rows.update(phase_flash(torch, checks))
    launches.update(phase_lm(torch, checks, smi))
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
