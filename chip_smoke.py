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
   The resident route (`power_iter.routes(c, dtype, k)` with k >= 2
   passes over T: a cluster per slice holding it in shared memory) is
   also held to the plain version and timed against the streaming routes
   at (1000, 1000, 1000) k = 6, (6400, 400, 400) k = 8 and (1000, 1400,
   1400) k = 6 in fp32 and bf16, with its G, the share of a slice held,
   the clusters resident at once and each route's share of the bounds
   for T read once per launch and once per pass (`RESIDENT_SHAPES`).
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
11. The result cache at m = 200 (kernels, fp32): benchmarks/msc_cache.py's
   Zipf(1.2) stream of 240 draws over 6 gamma-3 tensors, 8 slots, in
   batches of 8, cache-off then cache-on: results bit for bit, hits = the
   draws of a tensor served in an earlier batch, a hit adds no dispatch;
   both walls and the key's cost per submit (copy to the host + SHA-256).
   Then 4 donors (gamma 1000) cold and 8 near-duplicates (0.3% of the
   std) warm under tol 1e-4: masks equal msc_sequential's, median sweeps
   below the cold median, nothing captured; the ratio.
12. The SLO scheduler at m = 200: benchmarks/msc_scheduler.py's schedule
   (40 requests, 4 slots, a class-1 near-noise backlog at tick 0, class-0
   arrivals every 2 ticks) under FIFO and with preempt-to-host: every
   request's bits equal, preemptions > 0, nothing captured; the p99
   interactive wait and ticks to drain of both.  A burst of 20 with
   24-tick deadlines with and without shedding (something shed, no more
   misses per admitted request), and two buckets (200, 208) with 0 idle
   ticks.
13. Checkpoints and faults on phase 5c's mix at 3 chunks a step: warm
   walls with and without a checkpoint every 10 chunk steps (bytes,
   write time, overhead, reported); a mid-solve checkpoint restored after
   close() on one device and on a (1,) NCCL mesh, one written on the mesh
   restored on one device; a child SIGKILLed after a chunk, restored
   here; one injected chunk and one refill failure (retries); a
   persistent failure (every request through msc_sequential on the card);
   a corrupt newest leaf (the previous step, with a warning): every
   result bit-identical to the uninterrupted run; 0 B left after each of
   phases 11-13.
14. The autotuner on phase 5c's mix (m = 200, 32 requests, 8 slots, fp32,
   kernels) with epilogue="auto", chunks_per_step="auto" and a
   persisted autotune cache: cold, one search per bucket (each candidate
   route of the power kernel captured as the bucket's two graphs and
   timed by replay; each candidate's time and the winner printed),
   2 x candidates graphs captured, `power_iter` and `abs_rowsum`
   launched; the memory held within the static buffers and the winner's
   graph pool (nothing left from the losers); warm, 0 searches and 0
   captures; a fresh engine reloading the cache, 0 searches, one hit and
   2 captures per bucket; masks and sweeps equal the untuned engine's (d
   within 3e-5); the mix served on every route compared with the current
   pick's (masks, sweeps, d and λ, reported); untuned and tuned warm
   walls in turns (reported).  Then `msc_serve --continuous --epilogue
   auto --chunks-per-step auto --autotune` at the reference's defaults
   on one device and on a (1,) NCCL mesh: one search per bucket, none
   and no capture in the stream; 0 B left.
15. The multi-host control plane (`launch/distributed.py`) on phase 5c's
   mix (m = 200, 32 requests, 8 slots, fp32, kernels).  15a:
   `MSCDistributedServer` with one process against the bare engine:
   every request's mask, d and sweeps bit for bit and every `ServeStats`
   counter equal, cold and warm; the server's warm run launches
   `power_iter` and `abs_rowsum`; warm walls in turns (reported).  15b:
   a format-2 step of the engine after 3 ticks (`_export_split`, then
   `begin_sharded_checkpoint` / `write_process_shards` /
   `commit_sharded_checkpoint`), its bytes and write time beside a
   format-1 checkpoint of the same state (reported); a step missing a
   process record refuses to commit and is never selected;
   `restore_after_host_loss` onto the card finishes the mix bit for bit
   as the uninterrupted run, launching both kernels; a shard corrupted by
   `corrupt_checkpoint_shard` is rejected under SHA.  15c, where
   `torch.cuda.device_count() >= 2`: `python -m
   repro_torch.launch.distributed --num-processes 2 --spawn-workers
   --device cuda` on the mix, clean and with a worker SIGKILLed at
   step:3 (`--ckpt-dir`, `--ckpt-every 2`): masks and sweeps of 15a's
   one-device run (d within 3e-5), host losses / restores / reinits 0 /
   0 / 0 and 1 / 1 / 1, the master ending on its own card and launching
   both kernels; the control plane's ms a tick in broadcast and acks,
   wire bytes a tick, recovery_s and the cold wall beside 15a's
   (reported).  With one card 15c prints that it needs two and runs
   nothing.
16. The MoE, SSM and hybrid archs at their published widths (random
   weights from seed 0): granite-moe-1b-a400m, mamba2-2.7b,
   recurrentgemma-2b and, last, qwen2-moe-a2.7b (~57 GB of fp32 master
   weights).  Each: `launch/serve.py --arch A --batch 16 --prompt-len 32
   --gen 16 --attn-impl pallas` in bf16 (no kernel launched: every
   self-attention has a KV cache), its prefill ms, decode ms per token,
   tokens/s and peak memory; the engine's decode graph in bf16 and fp32
   against an eager loop of `decode_step` (phase 7's check): captured
   once cold and never warm, no host sync in a replay, the last step's
   logits within 2e-2 / 1e-4 of max |logit| and in fp32 the same tokens,
   both warm times reported; the fp32
   prefill's last logits against the no-cache `forward` at (2, 300)
   within 2e-4 (the recurrences step by step against the chunked SSD and
   the log-depth RG-LRU scan; MoE with capacity_factor = E / k, so no
   side drops a token).  recurrentgemma-2b's no-cache forward at (1,
   4096) through `flash_attention` (attn_impl="pallas") against the
   chunked route on the same weights: hidden states within 1e-4 (fp32)
   and 2e-2 (bf16; or the chunked route's own bf16-to-fp32 distance
   where larger, both printed) of max |h|, exactly one launch per local
   layer (8), both times.  0 B left after each arch.
17. Training (`training/loop.py`, `training/steps.py`, `optim/`,
   `checkpoint/store.py:CheckpointManager`) under
   `torch.use_deterministic_algorithms(True)` (`CUBLAS_WORKSPACE_CONFIG`
   is set to :4096:8 before CUDA starts, PyTorch's own size on an H100).
   17a: qwen1.5-0.5b at its published size (bf16 compute, fp32 masters,
   random weights from seed 0), batch 8, seq 512 of
   `SyntheticLMDataset`, 12 steps, twice: `TrainLoop.run_with_restarts`
   with a checkpoint at step 6 and an injected failure at step 9, and
   an uninterrupted `TrainLoop.run`.  Every step's loss and the final
   parameters, moments and step bit for bit equal, the last loss below
   the first, no NaN, the memory back to its baseline once both are
   gone; prints the warm step ms (median), tokens/s, peak memory,
   checkpoint bytes and ms (the snapshot on the step path, the write
   and SHA-256 in a thread), the seconds from the failure to the first
   resumed step and the model-flops share of a step at 989 TFLOP/s.
   17b: qwen1.5-0.5b at full width and 2 layers, fp32, TF32 off, (2,
   128): the loss and every gradient leaf of the card within 1e-4 of the
   same code on the CPU (of that leaf's largest |g|).  17c:
   granite-moe-1b-a400m at its published size, bf16, batch 8, seq 512,
   6 steps of `build_train_step` with 1 and with 2 microbatches: finite
   losses and aux, the loss falls, the 2-microbatch step-1 loss within
   1e-2 of the 1-microbatch one; step ms, peak memory, tokens/s.  The
   four kernels are launched 0 times on this path (the reference's
   training takes its chunked attention only).
18. The LM over ranks, on a (data, model) = (1, 1) mesh of one NCCL rank
   (one card: NCCL takes one rank per device), each path against the
   one-device path on the same weights from seed 0.  18a (deterministic
   algorithms): qwen1.5-0.5b at its published size, (8, 512), bf16 on
   fp32 masters, 3 steps of `build_train_step` on one device and on the
   mesh: every loss and every state tensor bit for bit (the (1, 1) path
   runs the one-device operations in the same order, its collectives
   among one rank), the one-device losses equal to phase 17a's first 3;
   `TrainLoop` on the mesh with a checkpoint at step 1 and a crash at
   step 2: the uninterrupted mesh run's losses and state bit for bit;
   that step-1 checkpoint restored on one device and stepped to step 3
   there: the mesh run's state bit for bit.  18b: granite-moe-1b-a400m
   at its published size, (8, 512), 2 steps on the mesh: the step-1
   loss within 1e-5 relative of the one-device step's and every routing
   decision of step 1 (top-k indices, kept slots; forward and remat
   recompute) identical.  Step ms, tokens/s, peak memory and the
   collectives a step by kind are printed beside the one-device runs
   (and phase 17's); 0 kernel launches; 0 B left.  18c:
   granite-moe-1b-a400m, mamba2-2.7b and recurrentgemma-2b in fp32 at
   phase 16's batch and lengths through `ServeEngine(..., mesh=…)`: the
   one-device engine's tokens, the decode step one CUDA graph (captured
   once cold, none warm), decode ms a token beside the one-device
   engine's (and phase 16's); recurrentgemma-2b's (1, 4096) no-cache
   forward with attn_impl="pallas" on the mesh: one `flash_attention`
   launch per local layer (8), hidden states within 2e-4 of max |h| of
   the one-device forward; 0 B left after each arch.
19. The multi-pod dry run (`launch/dryrun.py`).  19a: one qwen1.5-0.5b
   train step at (8, 512) on one device, warm, under FlopCounterMode:
   its FLOPs and the bytes of its state and batch equal the dry run's
   trace of the same step exactly; the reckoned peak (arguments + traced
   temp) beside the first step's `torch.cuda.max_memory_allocated`, the
   report's H100 `bound_s` beside the measured step; 0 kernel launches,
   0 B left.  19b, run in child processes beside 19a: the CLI at
   `--arch qwen1.5-0.5b --shape train_4k --pods both`, `--arch
   mamba2-2.7b --shape decode_32k` and `--msc 1024 --msc-gram --pods
   both`: exit 0, every cell ok, one report a cell whose note says
   fits-hbm or EXCEEDS-HBM against 80e9 B; the children set up no CUDA
   and import neither jax nor the reference.
20. The MSC schedule's stages in isolation (`core/schedule.py`).  First
   their traced forms on fake process groups on the host
   (`launch/dryrun.py`), printed beside the H100 models: both epilogues
   at p = 4, 8, 32 and m = c = 1000 (collectives, link bytes, landing
   buffer) and the mode stage at p = 4, m = 96, q = 1, 2, 4, 8 (argument
   and temp bytes, all-reduces).  Then on a (1,) mesh of one NCCL rank
   (phase 8's group): 20a, `build_epilogue_rowsum` on a (1000, 1000)
   fp32 V (seed 0) under "allgather" and "ring" with kernels (one
   `abs_rowsum` launch each), each held to the same stage on its plain
   version within phase 3's `abs_rowsum` tolerance; the max |Δd| between
   the two and the median of CUDA-event times of each.  20b,
   `build_mode_runner` on mode 0 of phase 4's tensor (kernels on:
   `power_iter` and `abs_rowsum` launched): d, λ and sweeps bit-identical
   to the flat schedule's mode 0 on the same group; the traced argument
   bytes of `lower_mode_stage` at p = q = 1 equal to the card's block
   and mask bytes; the reckoned peak (arguments + traced temp) within 3%
   of `torch.cuda.max_memory_allocated` over the call; its median time.
   20c, with two cards or more: both stages over one NCCL rank a card
   (real ring exchanges), d within 1e-4 of 20a's and the mode stage's d
   and λ within 3e-5 of 20b's with equal sweeps; with four or more, the
   (2, 2) NCCL tests of `tests/test_torch_lm_mesh.py` (`RANKS_TESTS`:
   every family served and qwen1.5-0.5b and granite-moe trained on (2,
   2) against one device, the training gap traced to the gradients, the
   training CLI's crash and resume over four ranks), one pytest run
   bounded by the sum of the tests' own bounds (`RANKS_TIMEOUT_S`), its
   output printed.  With one card 20c prints that it did not run and
   why.  0 B left.
Phases 4, 5b, 5c and 8 print the H100 roofline models' predictions
beside their measured times (`roofline.H100`; reported, no bar).
`--only 3,11,12,13,14,15,16,17,18,19,20` (any subset) runs the card and
build phases and the named phases alone (a development run: no result
lines, exit code 3 when they pass; 3 is the kernels against their plain
versions and their times).

The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA card, or
outside a checkout of the repository, it exits nonzero and prints no
result.
"""
from __future__ import annotations

import json
import math
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
        route forced that takes its passes over T (the resident route the
        chunk and the iteration, not the one-pass matvec), against the
        plain version; each chunk again with a same-bits check."""
        plain = ref.power_iterate_chunk(s, v, k)
        plain_it = ref.power_iterate(s, v, n_iter)
        plain_mv = (ref.power_matvec(s, v),)
        r_, c_ = s.shape[-2:]
        for route in (None,) + kpi.routes(c_, s.dtype, k):
            tag = f"{label} route={route or kpi.route(c_, s.dtype, k, r_)}"
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
            if route in (None,) + kpi.routes(c_, s.dtype):
                mv = (f"{label} route={route or kpi.route(c_, s.dtype)}"
                      + ("" if route else " (auto)"))
                checks.compare("power_iter", f"power_matvec {mv}",
                               (kpi.power_matvec(s, v, route=route),),
                               plain_mv, tol[s.dtype])

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
            "route": kpi.route(c, dt, k, r),
            "route_ms": {rt: cuda_ms(torch, chunk_on(rt), 5)
                         for rt in kpi.routes(c, dt, k)},
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
    rows[("power_iter", "resident")] = power_resident_times(torch, checks,
                                                            gen)

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


# the resident route's shapes: the solve's gate chunk, the serving cell's
# step (16 slots of m = 400, a probe every 8 sweeps) and the paper's
# largest m, each against the streaming routes (these times set
# power_iter.RESIDENT)
RESIDENT_SHAPES = (((1000, 1000, 1000), 6), ((6400, 400, 400), 8),
                   ((1000, 1400, 1400), 6))


def power_resident_times(torch, checks, gen):
    """The resident route against its plain version and the streaming
    routes at RESIDENT_SHAPES in fp32 and bf16: same bits in two calls,
    its cluster (G CTAs, the share of a slice held in shared memory, the
    clusters resident at once) and each route's time and share of the
    bounds for T read once per launch and once per pass."""
    from repro_torch.kernels import power_iter as kpi
    from repro_torch.kernels import ref

    dev = torch.device(DEVICE)
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
    out = []
    for (b, r, c), k in RESIDENT_SHAPES:
        x32 = torch.randn((b, r, c), generator=gen, device=dev)
        v = torch.randn((b, c), generator=gen, device=dev)
        v /= v.norm(dim=-1, keepdim=True)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            name = str(dt).split(".")[-1]
            label = f"{name} {(b, r, c)} k={k}"
            got = kpi.power_iterate_chunk(x, v, k, route="resident")
            plain = ref.power_iterate_chunk(x, v, k)
            checks.compare("power_iter", f"power_iterate_chunk resident "
                           f"{label}", got, plain, tol[dt],
                           [None, None, plain[1].abs().max().item()])
            del plain
            again = kpi.power_iterate_chunk(x, v, k, route="resident")
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                checks.failures.append(f"power_iterate_chunk resident "
                                       f"{label}: two calls differ")
            del got, again
            elt = x.element_size()
            once, _ = bound_ms(b * r * c * elt + 2 * b * c * 4 + 2 * b * 4,
                               4 * b * r * c * k, name)
            per_pass = k * b * r * c * elt / HBM_BYTES_PER_S * 1e3
            plan = kpi.card_plan(r, c, dt)
            row = {"shape": [b, r, c], "k": k, "dtype": name,
                   "route": kpi.route(c, dt, k, r), "g": plan.g,
                   "rows_held": plan.rows, "band": plan.band,
                   "share_held": plan.share(r),
                   "clusters": kpi.resident_clusters(r, c, dt),
                   "bound_ms": once, "pass_bound_ms": per_pass,
                   "route_ms": {}}
            for rt in kpi.routes(c, dt, k):
                if rt != "general":
                    row["route_ms"][rt] = cuda_ms(torch, lambda: (
                        kpi.power_iterate_chunk(x, v, k, route=rt)), 5)
            out.append(row)
            times = ", ".join(
                f"{rt} {t:.3f} ms ({100 * once / t:.1f}% of T once, "
                f"{100 * per_pass / t:.1f}% of T once a pass)"
                for rt, t in row["route_ms"].items())
            log(f"  time resident {label}: G={plan.g} (band {plan.band}, "
                f"{plan.rows} rows held, {100 * row['share_held']:.1f}% of "
                f"the slice), {row['clusters']} clusters resident at once; "
                f"{times}; route() picks {row['route']}")
            del x
        del x32
        torch.cuda.empty_cache()
    return out


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
            f"time is data and the sim metric), rec={rec['rec']:.3f}; "
            + h100_model((M,) * 3, _sweeps(rec["result"]),
                         dtype_bytes=2.0 if "bf16" in label else 4.0))
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


def h100_model(shape, sweeps, *, B=1, p=1, q=1, relayout="gspmd",
               dtype_bytes=4.0):
    """The H100 roofline models' time for B requests of `shape` at
    `sweeps` sweeps a mode, printed beside a measured time (reported, no
    bar): `serving_model`'s work (the eigensolve and epilogue models: their
    flops and link bytes) and `relayout_model`'s `relayout` latency (every
    sweep also reads the block at the HBM rate)."""
    from repro_torch.roofline import H100, relayout_model, serving_model

    work = serving_model(shape, B, p, q, sweeps=sweeps, dispatch_s=0.0,
                         dtype_bytes=dtype_bytes, hw=H100)["batched_s"]
    floor = relayout_model(shape, p, q, B=B, sweeps=sweeps,
                           dtype_bytes=dtype_bytes, hw=H100)[f"{relayout}_s"]
    return (f"H100 models (reported): work {work * 1e3:.3f} ms, with the "
            f"HBM floor {floor * 1e3:.2f} ms")


def _sweeps(res) -> int:
    """Mean realized sweeps over the modes of a result (the models take
    one count)."""
    return round(sum(int(res[j].power_iters_run) for j in range(3)) / 3)


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
        lock = max(_sweeps(got[i]) for i in idx)
        log(f"  warm m={m}, {len(idx)} requests in one dispatch: "
            + ", ".join(f"{k} {' / '.join(f'{x * 1e3:.2f}' for x in v)} ms "
                        f"({min(v) / g:.2f}x)" for k, v in t.items())
            + "; " + h100_model((m,) * 3, lock, B=len(idx)))
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
    from repro_torch.roofline import H100, continuous_serving_model

    pred = continuous_serving_model(
        [max(int(r[j].power_iters_run) for j in range(3)) for r in res_c],
        CONT_B, check_every=chunk, shape=(CONT_M,) * 3, hw=H100)
    log(f"  H100 models (reported): continuous "
        f"{pred['continuous_s'] * 1e3:.3f} ms, static "
        f"{pred['static_s'] * 1e3:.3f} ms, occupancy "
        f"{pred['occupancy_continuous']:.3f} / {pred['occupancy_static']:.3f}")
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


def graphed_decode(torch, checks, model, params, batch, cdt, tol,
                   label=""):
    """The engine's captured decode step against the eager loop on the
    same model, weights and prompt: one capture cold and none warm, fp32
    tokens identical, the last step's logits within `tol` of the eager
    ones fed the same tokens, no host sync in the replays; decode ms per
    token of both.  The engine is closed after."""
    from repro_torch.serving.engine import ServeEngine

    max_len = LM_PROMPT + 2 * LM_GEN  # room for LM_GEN more replays
    engine = ServeEngine(model, params, LM_B, max_len)
    engine.generate(batch, LM_GEN)  # cold: one eager step, the capture
    step = engine._decode
    toks = engine.generate(batch, LM_GEN)  # warm: replays only
    once = engine.captures == 1 and engine._decode is step
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
    engine.close()
    eager_decode(torch, model, params, batch, LM_GEN, max_len)  # warm-up
    e_toks, e_ms = eager_decode(torch, model, params, batch, LM_GEN, max_len)
    want = teacher_forced(torch, model, params, batch, toks, max_len)[-1]
    rel = ((last - want).abs().max() / want.abs().max()).item()
    same = torch.equal(toks, e_toks)
    ok = (rel <= tol and not synced and once
          and (same or cdt != "float32"))
    log(f"  {'ok  ' if ok else 'FAIL'} {label}{cdt} decode from one CUDA "
        f"graph per step (captured once cold, none warm: {once}): "
        f"{g_ms:.3f} ms per token (eager loop {e_ms:.3f} ms, "
        f"{e_ms / g_ms:.2f}x); tokens == eager loop's {same}; last logits "
        f"rel diff {rel:.3e} (tol {tol:g}); host sync in {LM_GEN} replays: "
        f"{synced or 'none'}")
    if not ok:
        checks.failures.append(f"{label}graphed decode {cdt}: tokens same "
                               f"{same}, logits rel {rel:.3e}, sync "
                               f"{synced}, captured once {once}")
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
        f"{counts}, {guard.calls} extractions with no host read; "
        + h100_model(tuple(tensor.shape), _sweeps(res),
                     relayout=relayout,
                     dtype_bytes=2.0 if cfg.precision != "fp32" else 4.0))
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


# ---------------------------------------------------------------- tiers --
# the serving tiers of the continuous engine at m = 200 (phases 11-13),
# under benchmarks/msc_continuous.py's gate (tol 3e-3, a probe every 8
# sweeps, cap 240)
TIER_M = 200
# phase 11: benchmarks/msc_cache.py's mix: a Zipf(1.2) stream of n draws
# over U planted tensors (gamma 3), then donors under a tight gate (tol
# 1e-4, cap 480) and near-duplicates 0.3% of the std away.  The donors'
# gamma is 1000, not the benchmark's 20: at m = 200 a gamma-20 solve
# never passes the tight gate (480 sweeps, the cap, cold and warm on the
# card: PERF.md, PR 20), while gamma 1000 takes ~200 sweeps cold
ZIPF_A, ZIPF_U, ZIPF_N, CACHE_SLOTS = 1.2, 6, 240, 8
GAMMA_POOL, GAMMA_DONOR, WARM_TOL, NEAR_REL = 3.0, 1000.0, 1e-4, 0.003
N_DONORS = 4
# phase 12: benchmarks/msc_scheduler.py's schedule: n requests through
# B slots, every 8th a class-1 near-noise backlog at tick 0, the rest
# class 0 arriving every 2 ticks
SCHED_N, SCHED_B = 40, 4
# phase 13: the skewed mix of phase 5c, 3 chunks a step; a checkpoint
# every 10 chunks in the timed run
FT_CHUNKS, FT_CKPT_EVERY = 3, 10


def tier_cfg(**kw):
    from repro_torch.core import MSCConfig

    return MSCConfig(epsilon=3e-4, power_tol=3e-3, power_iters=240,
                     power_check_every=8, use_kernels=True).with_(**kw)


def _planted(torch, seed, m, gamma):
    from repro_torch.core import PlantedSpec, make_planted_tensor

    return make_planted_tensor(
        torch.Generator(device=DEVICE).manual_seed(seed),
        PlantedSpec.paper(m, gamma))


def _bits(a, b):
    """Masks, sweeps and d of two results bit for bit."""
    return all(a[j].mask.cpu().equal(b[j].mask.cpu())
               and int(a[j].power_iters_run) == int(b[j].power_iters_run)
               and a[j].d.cpu().equal(b[j].d.cpu()) for j in range(3))


def _reset_counts():
    mods = counters()
    for mod in mods.values():
        mod.launches = 0
    return mods


def _read_counts(mods):
    return {n: mod.launches for n, mod in mods.items()}


def _gate(checks, ok, label, text):
    log(f"  {'ok  ' if ok else 'FAIL'} {text}")
    if not ok:
        checks.failures.append(f"{label}: {text}")


def _freed(torch, checks, label, base):
    """0 B left once the engines are closed and dropped."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - base
    _gate(checks, left == 0, label, f"{left} B left once closed")


def phase_cache(torch, checks, smi):
    """Phase 11 (`_cache_runs`), then 0 B left once its engines and
    tensors are gone.  Returns {label: launch counts}."""
    return _without_leftovers(torch, checks, "cache", _cache_runs, smi)


def _without_leftovers(torch, checks, label, runs, smi):
    """runs(torch, checks, smi) with the device memory allocated before it
    as the baseline: once it returns (its locals gone), none may be
    left."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    out = runs(torch, checks, smi)
    _freed(torch, checks, label, base)
    return out


def _cache_runs(torch, checks, smi):
    """The result cache on the card: benchmarks/msc_cache.py's Zipf mix
    cache-off then cache-on (bit-identical results, hits = repeats, a hit
    adds no dispatch), the key's cost per submit, then warm starts of
    near-duplicates (masks equal msc_sequential's, fewer sweeps than
    cold, nothing captured).  Returns {label: launch counts}."""
    import numpy as np

    from repro_torch.core import msc_sequential
    from repro_torch.core.fingerprint import (cache_salt, host_array,
                                              result_cache_key)
    from repro_torch.serving import MSCContinuousEngine, MSCResultCache

    label = f"cache tier 1 m={TIER_M} B={CACHE_SLOTS}"
    log(f"{label}: Zipf({ZIPF_A}) stream of {ZIPF_N} draws over {ZIPF_U} "
        f"tensors (gamma={GAMMA_POOL:g}); card: {smi}")
    cfg = tier_cfg()
    pool = [_planted(torch, SEED + i, TIER_M, GAMMA_POOL)
            for i in range(ZIPF_U)]
    rng = np.random.RandomState(0)
    probs = 1.0 / (np.arange(1, ZIPF_U + 1) ** ZIPF_A)
    draws = rng.choice(ZIPF_U, size=ZIPF_N, p=probs / probs.sum())
    stream = [pool[i] for i in draws]
    distinct = len(set(int(i) for i in draws))
    # a draw hits when its tensor was served in an earlier batch: repeats
    # within a batch are submitted before the first is served, and miss
    served, want_hits = set(), 0
    for i in range(0, ZIPF_N, CACHE_SLOTS):
        batch = [int(x) for x in draws[i:i + CACHE_SLOTS]]
        want_hits += sum(x in served for x in batch)
        served.update(batch)
    off = MSCContinuousEngine(cfg, slots=CACHE_SLOTS, device=DEVICE)
    on = MSCContinuousEngine(cfg, slots=CACHE_SLOTS, device=DEVICE,
                             result_cache=MSCResultCache(max_bytes=256 << 20))
    # both engines' graphs off the clock, on a tensor outside the pool
    warm_t = _planted(torch, SEED + 99, TIER_M, GAMMA_POOL)
    off.run([warm_t])
    on.run([warm_t])

    def serve(eng):
        out = []
        for i in range(0, ZIPF_N, CACHE_SLOTS):  # batch by batch
            out.extend(eng.run(stream[i:i + CACHE_SLOTS]))
        return out

    mods = _reset_counts()
    res_off, t_off = _timed_s(torch, lambda: serve(off))
    counts_off = _read_counts(mods)
    before = on.stats
    mods = _reset_counts()
    res_on, t_on = _timed_s(torch, lambda: serve(on))
    counts = _read_counts(mods)
    s_on = on.stats.delta(before)
    same = all(_bits(a, b) for a, b in zip(res_on, res_off))
    _gate(checks, same, label, f"cache-on results equal cache-off's bit for "
          f"bit ({ZIPF_N} requests)")
    _gate(checks, s_on.cache_hits == want_hits, label,
          f"cache_hits {s_on.cache_hits} = the draws of a tensor served in "
          f"an earlier batch ({want_hits}; n - distinct draws = "
          f"{ZIPF_N} - {distinct}, {ZIPF_N - distinct - want_hits} repeats "
          f"within a batch miss); misses {s_on.cache_misses}")
    drawn = sorted(set(int(i) for i in draws))
    before = on.stats
    hot = on.run([pool[i] for i in drawn])  # every one cached by now
    d_hot = on.stats.delta(before)
    first = [res_off[list(draws).index(i)] for i in drawn]
    _gate(checks, d_hot.cache_hits == len(drawn) and d_hot.dispatches == 0
          and all(_bits(a, b) for a, b in zip(hot, first)), label,
          f"{len(drawn)} hits added {d_hot.dispatches} dispatches (want 0), "
          f"the first solves' bits")
    # the key's cost per submit: device-to-host copy and SHA-256
    salt = cache_salt()
    t_copy, t_key = [], []
    for t in pool:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arr = host_array(t, np.float32)
        t1 = time.perf_counter()
        result_cache_key(arr, cfg, salt=salt)
        t_copy.append(t1 - t0)
        t_key.append(time.perf_counter() - t1)
    del t
    copy_ms, sha_ms = np.median(t_copy) * 1e3, np.median(t_key) * 1e3
    log(f"  walls: cache-off {t_off * 1e3:.1f} ms, cache-on "
        f"{t_on * 1e3:.1f} ms ({t_off / t_on:.3f}x; the reference's bar "
        f">= 5); {s_on.dispatches} dispatches cache-on against "
        f"{off.stats.dispatches} cache-off; launches cache-off {counts_off}, "
        f"cache-on {counts} ({smi})")
    log(f"  key per submit ({TIER_M}^3 fp32 on the card, "
        f"{pool[0].numel() * 4} B): copy to the host {copy_ms:.3f} ms + "
        f"SHA-256 {sha_ms:.3f} ms = {copy_ms + sha_ms:.3f} ms (median of "
        f"{ZIPF_U})")
    off.close()
    on.close()
    del off, on, res_off, res_on, hot, stream, pool, warm_t

    label_w = f"cache tier 2 (warm start) m={TIER_M} B={CACHE_SLOTS}"
    wcfg = cfg.with_(power_tol=WARM_TOL, power_iters=480)
    log(f"{label_w}: {N_DONORS} donors gamma={GAMMA_DONOR:g} cold, "
        f"{2 * N_DONORS} near-duplicates {NEAR_REL} of the std away, tol "
        f"{WARM_TOL:g}")
    donors = [_planted(torch, SEED + 100 + i, TIER_M, GAMMA_DONOR)
              for i in range(N_DONORS)]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    nears = []
    for i in range(2 * N_DONORS):
        d = donors[i % N_DONORS]
        nears.append(d + NEAR_REL * d.std() * torch.randn(
            d.shape, generator=gen, device=DEVICE))
    del d
    weng = MSCContinuousEngine(wcfg, slots=CACHE_SLOTS, device=DEVICE,
                               warm_start=True,
                               result_cache=MSCResultCache(256 << 20))
    cold, t_cold = _timed_s(torch, lambda: weng.run(donors))
    graphs = weng.graphs
    before = weng.stats
    mods = _reset_counts()
    with NoSyncInReplays(torch) as guard:
        warm, t_warm = _timed_s(torch, lambda: weng.run(nears))
    counts_w = _read_counts(mods)
    sw = weng.stats.delta(before)
    cold_sw = [max(int(r[j].power_iters_run) for j in range(3)) for r in cold]
    warm_sw = [max(int(r[j].power_iters_run) for j in range(3)) for r in warm]
    med_c, med_w = float(np.median(cold_sw)), float(np.median(warm_sw))
    same = all(all(r[j].mask.cpu().equal(
        msc_sequential(t, wcfg, device=DEVICE)[j].mask.cpu())
        for j in range(3)) for t, r in zip(nears, warm))
    _gate(checks, same, label_w, "every warm-started mask equals "
          "msc_sequential's on the card (kernels)")
    _gate(checks, med_w < med_c and sw.warm_starts == 2 * N_DONORS, label_w,
          f"median max-mode sweeps warm {med_w:g} < cold {med_c:g} "
          f"(ratio {med_w / med_c:.3f}; the reference's bar <= 0.5); "
          f"{sw.warm_starts} warm starts, {sw.warm_sweeps_saved} sweeps "
          f"saved")
    _gate(checks, sw.compiles == 0 and weng.graphs == graphs, label_w,
          f"{sw.compiles} graphs captured across the warm phase (want 0); "
          f"{guard.calls} replays with no host sync")
    log(f"  walls: {N_DONORS} donors cold {t_cold * 1e3:.1f} ms, "
        f"{2 * N_DONORS} near-duplicates warm {t_warm * 1e3:.1f} ms; "
        f"sweeps cold {cold_sw}, warm {warm_sw}; launches {counts_w} "
        f"({smi})")
    weng.close()
    return {label: counts, label_w: counts_w}


def _drive_schedule(eng, schedule, deadline_chunks=None):
    """Feed [(tick, tag, tensor, priority)] through submit/step; each
    request's wait (admission tick - submit tick) read off the slot
    tables, as benchmarks/msc_scheduler.py reads it.  Returns (results
    by tag, tag -> (priority, wait), ticks, shed tags)."""
    from repro_torch.serving import LoadShedError

    schedule = sorted(schedule, key=lambda e: e[0])
    nxt, tick, shed = 0, 0, []
    tag_of, submit_tick, prio_of, waits, results = {}, {}, {}, {}, {}
    while nxt < len(schedule) or eng.has_work():
        while nxt < len(schedule) and schedule[nxt][0] <= tick:
            _, tag, t, pr = schedule[nxt]
            nxt += 1
            try:
                rid = eng.submit(t, priority=pr,
                                 deadline_chunks=deadline_chunks)
            except LoadShedError:
                shed.append(tag)
                continue
            tag_of[rid], submit_tick[rid], prio_of[rid] = tag, tick, pr
        for rid, res in eng.step().items():
            results[tag_of[rid]] = res
        tick += 1
        for tb in eng._tables.values():
            for rid in tb.slot_req:
                if rid is not None and tag_of[rid] not in waits:
                    waits[tag_of[rid]] = (prio_of[rid],
                                          tick - submit_tick[rid])
    return results, waits, tick, shed


def phase_scheduler(torch, checks, smi):
    """Phase 12 (`_scheduler_runs`), then 0 B left.  Returns {label:
    launch counts}."""
    return _without_leftovers(torch, checks, "scheduler", _scheduler_runs,
                              smi)


def _scheduler_runs(torch, checks, smi):
    """The SLO scheduler on the card: benchmarks/msc_scheduler.py's
    schedule under FIFO and under the scheduler (preemption results
    bit-identical to FIFO's, preemptions, nothing captured warm), the
    two-bucket cell (no idle ticks) and shedding under overload.
    Returns {label: launch counts}."""
    import numpy as np

    from repro_torch.serving import MSCContinuousEngine

    label = f"scheduler m={TIER_M} B={SCHED_B}"
    log(f"{label}: {SCHED_N} requests, every {CONT_SLOW_EVERY}th class 1 "
        f"gamma={CONT_GAMMA_SLOW:g} at tick 0, the rest class 0 "
        f"gamma={CONT_GAMMA_FAST:g} every 2 ticks; card: {smi}")
    cfg = tier_cfg()
    tensors = [_planted(torch, SEED + i, TIER_M,
                        CONT_GAMMA_SLOW if i % CONT_SLOW_EVERY == 0
                        else CONT_GAMMA_FAST) for i in range(SCHED_N)]
    cls = [1 if i % CONT_SLOW_EVERY == 0 else 0 for i in range(SCHED_N)]
    schedule, k = [], 0
    for i, t in enumerate(tensors):
        if cls[i]:
            schedule.append((0, i, t, 1))
        else:
            schedule.append((2 + 2 * k, i, t, 0))
            k += 1
    del t

    def engine(**kw):
        e = MSCContinuousEngine(cfg, slots=SCHED_B, device=DEVICE,
                                preempt_min_remaining_chunks=1, **kw)
        e.run([tensors[0], tensors[1]])  # its graphs and a histogram
        return e

    fifo = engine(preempt=False)
    t0 = time.perf_counter()
    res_f, waits_f, ticks_f, _ = _drive_schedule(
        fifo, [(tk, i, t, 0) for tk, i, t, _ in schedule])
    wall_f = time.perf_counter() - t0
    fifo_int = [w for i, (_, w) in waits_f.items() if cls[i] == 0]
    sched = engine(preempt=True, aging_chunks=32)
    graphs = sched.graphs
    before = sched.stats
    mods = _reset_counts()
    with NoSyncInReplays(torch) as guard:
        t0 = time.perf_counter()
        res_s, waits_s, ticks_s, _ = _drive_schedule(sched, schedule)
        wall_s = time.perf_counter() - t0
    counts = _read_counts(mods)
    warm = sched.stats.delta(before)
    sched_int = [w for _, (pr, w) in waits_s.items() if pr == 0]

    def p99(v):
        return float(np.percentile(np.asarray(v, float), 99)) if v else 0.0

    same = all(_bits(res_s[i], res_f[i]) for i in range(SCHED_N))
    _gate(checks, same, label, "every request's masks, sweeps and d under "
          "the scheduler (preempted ones included) equal its FIFO run's")
    _gate(checks, warm.preemptions > 0 and warm.resumes == warm.preemptions,
          label, f"{warm.preemptions} preemptions, {warm.resumes} resumes")
    _gate(checks, warm.compiles == 0 and sched.graphs == graphs, label,
          f"{warm.compiles} graphs captured in the scheduled run (want 0); "
          f"{guard.calls} replays with no host sync")
    ratio = p99(fifo_int) / max(p99(sched_int), 1.0)
    log(f"  interactive p99 wait: FIFO {p99(fifo_int):.2f}, scheduler "
        f"{p99(sched_int):.2f} ticks ({ratio:.2f}x; the reference's bar "
        f">= 3); ticks to drain FIFO {ticks_f}, scheduler {ticks_s} "
        f"({ticks_f / ticks_s:.3f}; bar >= 0.95); walls {wall_f * 1e3:.1f} "
        f"/ {wall_s * 1e3:.1f} ms; per-class waits {sched.class_waits()}; "
        f"launches {counts} ({smi})")
    fifo.close()
    sched.close()
    del fifo, sched

    # overload: a burst at tick 0, deadlines 24 ticks, with and without
    # shedding (slo_chunks 6)
    burst = [(0, i, t, i % 2) for i, t in enumerate(tensors[:SCHED_N // 2])]
    miss, shed, admitted = {}, {}, {}
    for name, slo in (("noshed", None), ("shed", 6)):
        e = engine(preempt=True, slo_chunks=slo)
        b = e.stats
        _, _, _, tags = _drive_schedule(e, burst, deadline_chunks=24)
        d = e.stats.delta(b)
        miss[name], shed[name] = d.deadline_misses, d.slo_sheds
        admitted[name] = len(burst) - len(tags)
        e.close()
    rate = {n: miss[n] / max(admitted[n], 1) for n in miss}
    # the reference's bar: something shed, and no more misses per
    # admitted request than without shedding
    _gate(checks, shed["shed"] > 0 and rate["shed"] <= rate["noshed"], label,
          f"shedding: {shed['shed']} shed; deadline misses per admitted "
          f"request {miss['shed']}/{admitted['shed']} = {rate['shed']:.3f} "
          f"against {miss['noshed']}/{admitted['noshed']} = "
          f"{rate['noshed']:.3f} without")

    # two buckets (m and m + 8) under the weighted rotation
    mixed = [_planted(torch, SEED + 1000 + i, m, g) for i, (m, g) in
             enumerate([(TIER_M, CONT_GAMMA_FAST),
                        (TIER_M + 8, CONT_GAMMA_FAST)] * 4
                       + [(TIER_M, CONT_GAMMA_SLOW),
                          (TIER_M + 8, CONT_GAMMA_SLOW)])]
    mb = MSCContinuousEngine(cfg, slots=SCHED_B, device=DEVICE,
                             refill_min_free=1, bucket_policy="weighted")
    mb.run(mixed[:2])
    b = mb.stats
    mb.run(mixed, priorities=[i % 2 for i in range(len(mixed))])
    d_mb = mb.stats.delta(b)
    _gate(checks, d_mb.idle_bucket_ticks == 0 and d_mb.compiles == 0, label,
          f"two buckets ({TIER_M}, {TIER_M + 8}) at refill_min_free 1: "
          f"{d_mb.idle_bucket_ticks} idle-bucket ticks, {d_mb.compiles} "
          f"captures warm")
    mb.close()
    return {label: counts}


FT_CHILD = r'''
import json, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from repro_torch.core import MSCConfig, PlantedSpec, make_planted_tensor
from repro_torch.serving import MSCContinuousEngine
from repro_torch.serving.faults import FaultInjector, FaultPlan
cfg, ckpt, outdir = json.loads(sys.argv[2]), sys.argv[3], sys.argv[4]
spec = json.loads(sys.argv[5])
tensors = [make_planted_tensor(
    torch.Generator(device="cuda").manual_seed(spec["seed"] + i),
    PlantedSpec.paper(spec["m"], spec["slow"] if i % spec["every"] == 0
                      else spec["fast"])) for i in range(spec["n"])]
eng = MSCContinuousEngine(MSCConfig(**cfg), slots=spec["slots"],
                          chunks_per_step=spec["chunks"], device="cuda",
                          checkpoint_dir=ckpt,
                          ckpt_every_chunks=spec["ckpt_every"],
                          fault_injector=FaultInjector(
                              FaultPlan(kill_after_chunk=spec["kill"])))
for t in tensors:
    eng.submit(t)
while eng.has_work():
    for rid, res in eng.step().items():
        np.savez(os.path.join(outdir, "rid_%d.npz" % rid),
                 **{"m%d_%s" % (j, k): getattr(res[j], k).numpy()
                    for j in range(3) for k in ("mask", "d")},
                 **{"m%d_sweeps" % j: np.asarray(res[j].power_iters_run)
                    for j in range(3)})
raise SystemExit(7)  # the kill never fired
'''


class _Loaded:
    """A child's result for one mode, read back from its file."""

    def __init__(self, z, j):
        import torch

        self.mask = torch.from_numpy(z[f"m{j}_mask"])
        self.d = torch.from_numpy(z[f"m{j}_d"])
        self.power_iters_run = int(z[f"m{j}_sweeps"])


def _drain(eng, got):
    while eng.has_work():
        got.update(eng.step())
    return got


def phase_faults(torch, checks, smi):
    """Phase 13 (`_fault_runs`), then 0 B left.  Returns {label: launch
    counts}."""
    return _without_leftovers(torch, checks, "fault tolerance",
                              _fault_runs, smi)


def _fault_runs(torch, checks, smi):
    """Checkpoints, faults and restores on the card: the skewed mix of
    phase 5c with and without periodic checkpoints (their bytes, write
    time and overhead), a mid-solve checkpoint restored on one device
    and on a (1,) NCCL mesh (and the reverse), a SIGKILLed child
    restored here, injected transient and persistent failures, and a
    corrupt newest step.  Returns {label: launch counts}."""
    import dataclasses
    import json as js
    import shutil
    import signal
    import tempfile
    import warnings

    import numpy as np

    from repro_torch.core import msc_sequential
    from repro_torch.launch.mesh import join, leave, make_msc_mesh
    from repro_torch.serving import MSCContinuousEngine
    from repro_torch.serving.faults import (FaultInjector, FaultPlan,
                                            corrupt_checkpoint_leaf,
                                            fail_all_from)

    cfg = tier_cfg()
    label = (f"fault tolerance m={CONT_M} B={CONT_B} {FT_CHUNKS} chunks "
             f"a step")
    log(f"{label}: the skewed mix of phase 5c ({CONT_N} requests); card: "
        f"{smi}")
    stash = STASH.get("continuous")
    tensors = (stash["tensors"] if stash is not None else
               [_planted(torch, SEED + i, CONT_M,
                         CONT_GAMMA_SLOW if i % CONT_SLOW_EVERY == 0
                         else CONT_GAMMA_FAST) for i in range(CONT_N)])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    launches = {}
    try:
        def engine(**kw):
            return MSCContinuousEngine(cfg, slots=CONT_B,
                                       chunks_per_step=FT_CHUNKS,
                                       device=DEVICE, **kw)

        # ---- the overhead of periodic checkpoints, in turns
        plain = engine()
        ref = plain.run(tensors)  # cold: the captures
        ck_dir = os.path.join(tmp, "periodic")
        ckeng = engine(checkpoint_dir=ck_dir,
                       ckpt_every_chunks=FT_CKPT_EVERY)
        ckeng.run(tensors)
        writes = []
        orig = ckeng.checkpoint

        def timed_checkpoint():
            t0 = time.perf_counter()
            path = orig()
            writes.append((time.perf_counter() - t0, sum(
                os.path.getsize(os.path.join(path, f))
                for f in os.listdir(path))))
            return path

        ckeng.checkpoint = timed_checkpoint
        t = {"plain": [], "ckpt": []}
        for name in ("plain", "ckpt", "ckpt", "plain"):
            e = plain if name == "plain" else ckeng
            if name == "ckpt":
                writes.clear()  # the last run's checkpoints are reported
            mods = _reset_counts()
            before = e.stats
            out, s = _timed_s(torch, lambda: e.run(tensors))
            t[name].append(s)
            if name == "ckpt":
                launches[label] = _read_counts(mods)
                same = all(_bits(a, b) for a, b in zip(out, ref))
                d = e.stats.delta(before)
        _gate(checks, same and d.checkpoints_written > 0, label,
              f"with checkpoints every {FT_CKPT_EVERY} chunks: results as "
              f"without, {d.checkpoints_written} checkpoints a run")
        p_s, c_s = min(t["plain"]), min(t["ckpt"])
        n_w = len(writes)
        w_s = [w for w, _ in writes] or [0.0]
        w_b = [b for _, b in writes] or [0]
        log(f"  warm walls: without {' / '.join(f'{x * 1e3:.1f}' for x in t['plain'])} "
            f"ms, with {' / '.join(f'{x * 1e3:.1f}' for x in t['ckpt'])} ms: "
            f"overhead {(c_s - p_s) / p_s * 100:.1f}% (the reference's bar "
            f"<= 10%, reported); per checkpoint {min(w_b)}-{max(w_b)} B "
            f"written in {min(w_s) * 1e3:.1f}-{max(w_s) * 1e3:.1f} ms "
            f"({n_w} a run) ({smi})")
        ckeng.close()
        plain.close()
        del plain, ckeng

        # ---- a mid-solve checkpoint, close(), restore: one device
        mid_dir = os.path.join(tmp, "mid")
        eng = engine(checkpoint_dir=mid_dir, ckpt_every_chunks=0)
        rids = [eng.submit(x) for x in tensors]
        got = {}
        for _ in range(4):
            got.update(eng.step())
        eng.checkpoint()
        graphs_cold = eng.stats.compiles
        eng.close()
        before_ckpt = dict(got)
        re1 = MSCContinuousEngine.restore(mid_dir, device=DEVICE)
        _drain(re1, got)
        same = sorted(got) == sorted(rids) and all(
            _bits(got[r], ref[i]) for i, r in enumerate(rids))
        new = re1.stats.compiles - graphs_cold
        _gate(checks, same and re1.stats.restores == 1
              and new == GRAPHS_PER_CONT_BUCKET, label,
              f"mid-solve checkpoint (after 4 ticks, {len(before_ckpt)} "
              f"done), close(), restore: bits of the uninterrupted run; "
              f"the restored engine captured {new} graphs (its table's "
              f"{GRAPHS_PER_CONT_BUCKET}) and nothing for the resumed "
              f"slots")
        re1.close()
        del re1, eng

        # ---- the same checkpoint on a (1,) NCCL mesh, and one written
        # on the mesh restored on one device
        mesh_dir = os.path.join(tmp, "mesh")
        try:
            dev = join(torch.device(DEVICE).type, rank=0, world_size=1,
                       store_file=os.path.join(tmp, "store"))
            mesh = make_msc_mesh("flat", (1,))
            got_m = dict(before_ckpt)
            rm = MSCContinuousEngine.restore(mid_dir, mesh=mesh, device=dev)
            _drain(rm, got_m)
            rm.close()
            meng = MSCContinuousEngine(cfg, slots=CONT_B,
                                       chunks_per_step=FT_CHUNKS, mesh=mesh,
                                       checkpoint_dir=mesh_dir,
                                       ckpt_every_chunks=0)
            mr = [meng.submit(x) for x in tensors]
            got_w = {}
            for _ in range(4):
                got_w.update(meng.step())
            meng.checkpoint()
            meng.close()
            del rm, meng
        finally:
            leave()
        r1 = MSCContinuousEngine.restore(mesh_dir, device=DEVICE)
        _drain(r1, got_w)
        r1.close()
        same_a = all(_bits(got_m[r], ref[i]) for i, r in enumerate(rids))
        same_b = sorted(got_w) == sorted(mr) and all(
            _bits(got_w[r], ref[i]) for i, r in enumerate(mr))
        _gate(checks, same_a and same_b, label,
              f"restored onto a (1,) NCCL mesh: bits equal {same_a}; "
              f"written on (1,), restored on one device: bits equal "
              f"{same_b}")
        del r1

        # ---- a child SIGKILLed after chunk k, restored here
        kill_dir, out_dir = os.path.join(tmp, "kill"), os.path.join(tmp,
                                                                    "out")
        os.makedirs(out_dir)
        spec = {"seed": SEED, "m": CONT_M, "n": CONT_N,
                "every": CONT_SLOW_EVERY, "slow": CONT_GAMMA_SLOW,
                "fast": CONT_GAMMA_FAST, "slots": CONT_B,
                "chunks": FT_CHUNKS, "ckpt_every": 4, "kill": 9}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", FT_CHILD, SRC,
             js.dumps(dataclasses.asdict(cfg)), kill_dir, out_dir,
             js.dumps(spec)], capture_output=True, text=True, timeout=300)
        child_s = time.perf_counter() - t0
        got_k = {}
        for f in os.listdir(out_dir):
            with np.load(os.path.join(out_dir, f)) as z:
                got_k[int(f[4:-4])] = [_Loaded(z, j) for j in range(3)]
        killed = proc.returncode == -signal.SIGKILL
        n_before = len(got_k)
        rk = MSCContinuousEngine.restore(kill_dir, device=DEVICE)
        step = rk._total_chunks
        _drain(rk, got_k)
        rk.close()
        same = sorted(got_k) == list(range(CONT_N)) and all(
            _bits(got_k[i], ref[i]) for i in range(CONT_N))
        _gate(checks, killed and same, label,
              f"child SIGKILLed after chunk {spec['kill']} (rc "
              f"{proc.returncode}, {child_s:.1f} s, {n_before} results "
              f"delivered before), restored here from step {step}: bits "
              f"equal {same}" + ("" if killed else f"; stderr "
                                 f"{proc.stderr[-400:]}"))
        del rk

        # ---- injected failures: one chunk and one refill (transient),
        # then a persistent one
        fe = engine(retry_backoff_s=0.0, fault_injector=FaultInjector(
            FaultPlan(fail_chunks=(3,), fail_refills=(2,))))
        out = fe.run(tensors)
        same = all(_bits(a, b) for a, b in zip(out, ref))
        _gate(checks, same and fe.stats.retries >= 2
              and fe.stats.fallback_requests == 0, label,
              f"one injected chunk and one refill failure: "
              f"{fe.stats.retries} retries, bits equal {same}, "
              f"{fe.stats.fallback_requests} fallback-served")
        fe.close()
        pe = engine(retry_backoff_s=0.0, max_retries=2,
                    fault_injector=FaultInjector(FaultPlan(
                        fail_chunks=fail_all_from(2))))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            mods = _reset_counts()
            out, s_fb = _timed_s(torch, lambda: pe.run(tensors))
            counts_fb = _read_counts(mods)
        seq = [msc_sequential(x, cfg, device=DEVICE) for x in tensors]
        same = all(all(a[j].mask.cpu().equal(b[j].mask.cpu())
                       and int(a[j].power_iters_run)
                       == int(b[j].power_iters_run) for j in range(3))
                   for a, b in zip(out, seq))
        n_fb = pe.stats.fallback_requests
        _gate(checks, same and n_fb + pe.stats.evictions == CONT_N
              and n_fb > 0 and counts_fb["power_iter"] > 0
              and any("sequential oracle" in str(x.message) for x in w),
              label, f"persistent failure from chunk 2: {n_fb} requests "
              f"(every live and queued one) through msc_sequential on the "
              f"card ({counts_fb['power_iter']} power_iter launches, "
              f"{s_fb * 1e3:.1f} ms), {pe.stats.evictions} served before; "
              f"masks and sweeps equal msc_sequential's: {same}")
        launches[f"{label} fallback"] = counts_fb
        pe.close()
        del fe, pe, seq, out

        # ---- the newest leaf corrupted: restore from the previous step
        cor_dir = os.path.join(tmp, "corrupt")
        ce = engine(checkpoint_dir=cor_dir, ckpt_every_chunks=0,
                    keep_checkpoints=5)
        cr = [ce.submit(x) for x in tensors]
        got_c = dict(ce.step())
        p1 = ce.checkpoint()
        got_c.update(ce.step())
        p2 = ce.checkpoint()
        ce.close()
        corrupt_checkpoint_leaf(cor_dir, int(os.path.basename(p2)[5:]))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            rc = MSCContinuousEngine.restore(cor_dir, device=DEVICE)
        warned = any("failed" in str(x.message) for x in w)
        step_ok = rc._total_chunks == int(os.path.basename(p1)[5:])
        got_rc = _drain(rc, {})
        rc.close()
        same = all(_bits(got_rc.get(r, got_c.get(r)), ref[i])
                   for i, r in enumerate(cr))
        _gate(checks, warned and step_ok and same, label,
              f"newest leaf corrupted: a warning {warned}, restored from "
              f"the previous step {step_ok}, bits equal {same}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# phase 14: the autotuner on phase 5c's skewed mix
AUTOTUNE_LABEL = f"autotuned continuous kernels fp32 m={CONT_M} B={CONT_B}"


def phase_autotune(torch, checks, smi):
    """Phase 14 (`_autotune_runs`), then 0 B left once its engines and
    tensors are gone.  Returns {label: launch counts}."""
    from repro_torch.serving.graphs import capture_stream

    # the process's capture stream (and its cuBLAS workspace) outlives
    # the phase: made before the baseline when this phase runs alone
    capture_stream(DEVICE)
    return _without_leftovers(torch, checks, "autotune", _autotune_runs, smi)


def _skewed_mix(torch):
    """Phase 5c's 32 requests at m = 200 (every 8th gamma = 2)."""
    return [_planted(torch, SEED + i, CONT_M,
                     CONT_GAMMA_SLOW if i % CONT_SLOW_EVERY == 0
                     else CONT_GAMMA_FAST) for i in range(CONT_N)]


def _autotune_runs(torch, checks, smi):
    """The continuous engine with every "auto" knob and the autotuner on
    phase 5c's mix: a cold pass searches each bucket once (each candidate
    route captured as the bucket's two graphs and timed by replay), a warm
    pass searches and captures nothing, a fresh engine reloading the
    persisted cache searches nothing and captures only the winner's two
    graphs per bucket; masks and sweeps equal the untuned engine's (d
    within 3e-5), no bytes are left from the losing candidates, and the
    power kernel and the epilogue kernel run inside the timed graphs.  Then
    `msc_serve --continuous --epilogue auto --chunks-per-step auto
    --autotune` on one device and on a (1,) NCCL mesh."""
    import shutil
    import tempfile

    from repro_torch.core.autotune import AutotuneCache
    from repro_torch.launch import msc_serve
    from repro_torch.launch.mesh import join, leave
    from repro_torch.serving import MSCContinuousEngine

    label = AUTOTUNE_LABEL
    cfg = tier_cfg()
    tensors = _skewed_mix(torch)
    log(f"{label}: phase 5c's mix with epilogue='auto', chunks_per_step="
        f"'auto', autotune on; card: {smi}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    plain = MSCContinuousEngine(cfg, slots=CONT_B, device=DEVICE)
    res_p = plain.run(tensors)
    torch.cuda.synchronize()
    held_plain = torch.cuda.memory_allocated() - base
    tmp = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    try:
        def tuned():
            return MSCContinuousEngine(
                cfg.with_(epilogue="auto"), slots=CONT_B, device=DEVICE,
                chunks_per_step="auto",
                autotune_cache=AutotuneCache(persist_dir=tmp))

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        mods = _reset_counts()
        eng = tuned()
        res_c, cold_s = _timed_s(torch, lambda: eng.run(tensors))
        counts = _read_counts(mods)
        cold = eng.stats
        held = torch.cuda.memory_allocated() - base
        static_b, pools = eng.memory_reckoning()
        entries = eng.autotune_cache.entries()
        n_b = len(eng._tables)
        n_cands = sum(len(e["timings"]) for e in entries.values())
        for key, e in entries.items():
            times = ", ".join(
                f"{json.loads(c)['power_route']} {t * 1e3:.3f} ms"
                for c, t in e["timings"].items())
            log(f"  bucket {key.split('|')[0]}: replay of step + refill "
                f"per candidate: {times}; winner {e['power_route']} "
                f"(epilogue {e['epilogue']}) ({smi})")
        _gate(checks, cold.autotune_searches == n_b
              and cold.compiles == 2 * n_cands and eng.graphs == 2 * n_b,
              label,
              f"cold: {cold.autotune_searches} searches for {n_b} buckets, "
              f"{cold.compiles} graphs captured for {n_cands} candidates "
              f"(want 2 each), {eng.graphs} held")
        _gate(checks, counts["power_iter"] > 0 and counts["abs_rowsum"] > 0,
              label, f"launches of the cold pass (the timed replays "
              f"included) {counts}")
        # a losing candidate's graphs left alive would add their
        # allocations (~1.7 MB a candidate at this bucket) to the table's
        _gate(checks, held <= static_b + pools
              and held <= held_plain + (1 << 16), label,
              f"device memory held after the search {held} B (the untuned "
              f"engine's {held_plain} B), reckoned {static_b} B static + "
              f"{pools} B of the winner's graph pool: nothing left from "
              "the losing candidates")
        with NoSyncInReplays(torch) as guard:
            before = eng.stats
            res_w, warm_s = _timed_s(torch, lambda: eng.run(tensors))
            warm = eng.stats.delta(before)
        _gate(checks, warm.autotune_searches == 0 and warm.compiles == 0
              and warm.autotune_cache_hits == 0, label,
              f"warm: {warm.autotune_searches} searches, {warm.compiles} "
              f"captures; {guard.calls} replays with no host sync")
        same = (_same_requests(res_c, res_p, d_tol=3e-5)
                and _same_requests(res_w, res_c))
        _gate(checks, same, label, "masks and sweeps equal the untuned "
              "engine's, d within 3e-5")
        # warm walls in turns: untuned, tuned, tuned, untuned
        t = {"untuned": [], "tuned": []}
        for name in ("untuned", "tuned", "tuned", "untuned"):
            e = plain if name == "untuned" else eng
            t[name].append(_timed_s(torch, lambda: e.run(tensors))[1])
        log(f"  warm {CONT_N} requests (reported): untuned "
            f"{' / '.join(f'{x * 1e3:.2f}' for x in t['untuned'])} ms, "
            f"tuned {' / '.join(f'{x * 1e3:.2f}' for x in t['tuned'])} ms; "
            f"cold tuned pass {cold_s * 1e3:.1f} ms ({smi})")
        eng.close()
        del eng
        again = tuned()
        res_r = again.run(tensors)
        st = again.stats
        _gate(checks, st.autotune_searches == 0
              and st.autotune_cache_hits == n_b
              and st.compiles == 2 * n_b and _same_requests(res_r, res_c),
              label, f"reloaded cache: {st.autotune_searches} searches, "
              f"{st.autotune_cache_hits} hits, {st.compiles} graphs "
              "captured (the winners' 2 per bucket), results as the cold "
              "pass's")
        again.close()
        plain.close()
        del again, plain
        _across_routes(torch, cfg, tensors, entries, res_c, smi)

        for mesh_shape in (None, "1"):
            argv = ["--device", DEVICE, "--continuous", "--epilogue", "auto",
                    "--chunks-per-step", "auto", "--autotune"]
            where = "one device"
            if mesh_shape:
                argv += ["--mesh-shape", mesh_shape]
                where = "a (1,) NCCL mesh"
            log(f"{label}: msc_serve {' '.join(argv[2:])} on {where}")
            try:
                if mesh_shape:
                    dev = join("cuda", rank=0, world_size=1,
                               store_file=os.path.join(tmp, "store"))
                    with NoSyncInReplays(torch) as guard:
                        res = msc_serve._serve(msc_serve.parse_args(argv),
                                               dev)
                else:
                    with NoSyncInReplays(torch) as guard:
                        res = msc_serve.run(msc_serve.parse_args(argv))
                cont, nb = res["continuous"], len(res["buckets"])
                cs = cont["engine"].stats
                ok = (len(cont["results"]) == 9
                      and cs.autotune_searches == nb
                      and cont["stats_stream"].compiles == 0
                      and cont["engine"].graphs == 2 * nb)
                _gate(checks, ok, f"{label} msc_serve ({where})",
                      f"9 results; {cs.autotune_searches} searches for {nb} "
                      f"buckets, {cont['stats_warmup'].compiles} graphs "
                      f"captured warming up, "
                      f"{cont['stats_stream'].compiles} in the stream, "
                      f"{cont['engine'].graphs} held; {guard.calls} replays "
                      "with no host sync")
                msc_serve._close(res)
                del res, cont
            finally:
                if mesh_shape:
                    leave()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {label: counts}


def _across_routes(torch, cfg, tensors, entries, res_c, smi):
    """The mix served on each candidate route in turn (the cold pass's
    winners with the route replaced, through a cache that hits): masks,
    sweeps, d and λ against the current pick's (`power_iter.route`, the
    first candidate), reported."""
    from repro_torch.core.autotune import AutotuneCache
    from repro_torch.serving import MSCContinuousEngine

    routes = []
    for e in entries.values():
        for c in e["timings"]:
            r = tuple(json.loads(c)["power_route"])
            if r not in routes:
                routes.append(r)
    got = {}
    for r in routes:
        ac = AutotuneCache()
        for key, e in entries.items():
            ac.put(key, dict(e, power_route=list(r)))
        e = MSCContinuousEngine(cfg.with_(epilogue="auto"), slots=CONT_B,
                                device=DEVICE, chunks_per_step="auto",
                                autotune_cache=ac)
        got[r] = e.run(tensors)
        e.close()
    ref = got[routes[0]]
    for r in routes[1:]:
        same = _same_requests(got[r], ref)
        bits = _same_requests(got[r], ref, d_tol=0.0) and all(
            x[j].lambdas.cpu().equal(y[j].lambdas.cpu())
            for x, y in zip(got[r], ref) for j in range(3))

        def rel(f):
            return max(float((getattr(x[j], f).cpu().double()
                              - getattr(y[j], f).cpu().double()).abs().max()
                             / getattr(y[j], f).cpu().double().abs().max())
                       for x, y in zip(got[r], ref) for j in range(3))

        log(f"  route {r} against {routes[0]} (reported): masks and sweeps "
            f"equal {same}, bits equal {bits}, d max rel diff "
            f"{rel('d'):.3e}, λ max rel diff {rel('lambdas'):.3e} ({smi})")
    win = tuple(next(iter(entries.values()))["power_route"])
    log(f"  the tuned engine's bits equal those of the route it won on "
        f"({win}): {_same_requests(res_c, got[win], d_tol=0.0)}")


# phase 15: the multi-host control plane on phase 5c's mix (m = 200, 32
# requests, 8 slots, fp32, kernels, tol 3e-3, a probe every 8 sweeps,
# cap 240)
MH_MID_TICKS = 3
MH_CLI_TIMEOUT = 600


def phase_multihost(torch, checks, smi):
    """Phase 15 (`_multihost_runs`), then 0 B left once its engines are
    gone.  Returns {label: launch counts}."""
    from repro_torch.serving.graphs import capture_stream

    # the process's capture stream (and its cuBLAS workspace) outlives
    # the phase: made before the baseline when this phase runs alone
    capture_stream(DEVICE)
    return _without_leftovers(torch, checks, "multi-host control plane",
                              _multihost_runs, smi)


def _step_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _multihost_runs(torch, checks, smi):
    """15a: `MSCDistributedServer` with one process against the bare
    engine (results bit for bit, every counter equal; warm walls in
    turns).  15b: a format-2 step of a mid-solve engine (`_export_split`
    and the store's two phases), timed beside a format-1 checkpoint of
    the same state; a torn step never selected; the step restored by
    `restore_after_host_loss` on the card, the mix finished bit for bit;
    a corrupted shard rejected under SHA.  15c: the two-process CLI on
    two cards, clean and with a worker SIGKILLed at step:3, against 15a
    (needs two cards; with one it says so and runs nothing).  Returns
    {label: launch counts}."""
    import dataclasses
    import shutil
    import tempfile
    import warnings

    import numpy as np

    from repro_torch.checkpoint.store import (begin_sharded_checkpoint,
                                              commit_sharded_checkpoint,
                                              load_leaves, restorable_steps,
                                              save_checkpoint,
                                              write_process_shards)
    from repro_torch.launch.distributed import (DistributedSpec,
                                                MSCDistributedServer)
    from repro_torch.launch.elastic import restore_after_host_loss
    from repro_torch.serving import MSCContinuousEngine
    from repro_torch.serving.faults import corrupt_checkpoint_shard

    cfg = tier_cfg()
    tensors = _skewed_mix(torch)
    launches = {}

    # ---- 15a: one process, against the bare engine
    label = f"multi-host 1 process m={CONT_M} B={CONT_B}"
    log(f"{label}: phase 5c's mix ({CONT_N} requests) through "
        f"MSCDistributedServer(num_processes=1) and the bare engine; card: "
        f"{smi}")
    bare = MSCContinuousEngine(cfg, slots=CONT_B, device=DEVICE)
    server = MSCDistributedServer(DistributedSpec(num_processes=1), cfg,
                                  slots=CONT_B, device=DEVICE)
    ref, cold_bare = _timed_s(torch, lambda: bare.run(tensors))
    via, cold_srv = _timed_s(torch, lambda: server.serve(tensors))
    same = all(_bits(a, b) for a, b in zip(via, ref))
    stats_eq = dataclasses.astuple(bare.stats) == dataclasses.astuple(
        server.stats)
    _gate(checks, same and stats_eq, label,
          f"cold: every request's mask, d and sweeps bit for bit: {same}; "
          f"every ServeStats counter equal: {stats_eq} "
          f"({server.stats.compiles} graphs captured each)")
    t = {"engine": [], "server": []}
    for name in ("engine", "server", "server", "engine"):
        if name == "server":
            mods = _reset_counts()
            out, s = _timed_s(torch, lambda: server.serve(tensors))
            launches[label] = counts = _read_counts(mods)
            same = same and all(_bits(a, b) for a, b in zip(out, ref))
        else:
            out, s = _timed_s(torch, lambda: bare.run(tensors))
        t[name].append(s)
    stats_eq = dataclasses.astuple(bare.stats) == dataclasses.astuple(
        server.stats)
    _gate(checks, same and stats_eq and counts["power_iter"] > 0
          and counts["abs_rowsum"] > 0, label,
          f"warm: bits and counters still equal ({same}, {stats_eq}); the "
          f"server's warm run launched {counts}")
    e_s, s_s = min(t["engine"]), min(t["server"])
    log(f"  warm walls in turns: engine "
        f"{' / '.join(f'{x * 1e3:.2f}' for x in t['engine'])} ms, server "
        f"{' / '.join(f'{x * 1e3:.2f}' for x in t['server'])} ms; server / "
        f"engine {s_s / e_s:.4f}x; cold {cold_bare * 1e3:.1f} / "
        f"{cold_srv * 1e3:.1f} ms ({smi})")
    server.engine.close()
    bare.close()
    del server, bare

    # ---- 15b: format 2 on the card
    label = f"multi-host format 2 m={CONT_M} B={CONT_B}"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fmt2_")
    try:
        eng = MSCContinuousEngine(cfg, slots=CONT_B, device=DEVICE)
        rids = [eng.submit(x) for x in tensors]
        got = {}
        for _ in range(MH_MID_TICKS):
            got.update(eng.step())
        step = eng._total_chunks
        d2, d1 = os.path.join(tmp, "fmt2"), os.path.join(tmp, "fmt1")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        device, host, meta = eng._export_split()
        stage = begin_sharded_checkpoint(d2, step)
        n_files = write_process_shards(stage, 0, device)
        commit_sharded_checkpoint(d2, step, num_processes=1,
                                  full_leaves=host, extra=meta)
        w2 = time.perf_counter() - t0
        t0 = time.perf_counter()
        leaves, meta1 = eng._export()
        save_checkpoint(d1, step, leaves, extra=meta1)
        w1 = time.perf_counter() - t0
        b2 = _step_bytes(os.path.join(d2, f"step_{step:08d}"))
        b1 = _step_bytes(os.path.join(d1, f"step_{step:08d}"))
        shard_b = sum(os.path.getsize(os.path.join(d2, f"step_{step:08d}",
                                                   f"leaf_{i:05d}_p000_s000"
                                                   ".npy"))
                      for i, *_ in device)
        log(f"  after {MH_MID_TICKS} ticks ({len(got)} done): format 2 "
            f"{b2} B ({n_files} shard files, {shard_b} B of them) in "
            f"{w2 * 1e3:.1f} ms; format 1 of the same state {b1} B in "
            f"{w1 * 1e3:.1f} ms ({smi})")
        # a torn step: process 1's record never came
        stage = begin_sharded_checkpoint(d2, step + 1)
        write_process_shards(stage, 0, device)
        try:
            commit_sharded_checkpoint(d2, step + 1, num_processes=2,
                                      full_leaves=host, extra=meta)
            refused = False
        except IOError:
            refused = True
        selected = restorable_steps(d2, verify_sha=True)
        _gate(checks, refused and selected == [step], label,
              f"a step missing a process record refuses to commit "
              f"({refused}) and stays .tmp; restorable steps {selected}")
        eng.close()
        del eng, device, host, leaves
        mods = _reset_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            re = restore_after_host_loss(d2, device=DEVICE,
                                         checkpoint_dir=d2,
                                         ckpt_every_chunks=0)
        on_card = re.device.type == "cuda" and re.mesh is None
        _drain(re, got)
        counts = _read_counts(mods)
        launches[label] = counts
        same = sorted(got) == sorted(rids) and all(
            _bits(got[r], ref[i]) for i, r in enumerate(rids))
        _gate(checks, same and on_card and re.stats.restores == 1
              and counts["power_iter"] > 0 and counts["abs_rowsum"] > 0,
              label,
              f"restore_after_host_loss on {re.device} (no mesh): the mix "
              f"finished bit for bit as the uninterrupted run: {same}; "
              f"launches {counts}")
        re.close()
        del re
        corrupt_checkpoint_shard(d2, step)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rejected = restorable_steps(d2, verify_sha=True) == []
        try:
            load_leaves(d2, step, verify=True)
            raised = False
        except IOError:
            raised = True
        _gate(checks, rejected and raised, label,
              f"a corrupted shard: the step rejected under SHA "
              f"({rejected}), load_leaves raises ({raised})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 15c: two processes, one card each
    label = f"multi-host 2 processes m={CONT_M} B={CONT_B}"
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"{label}: needs two cards (one rank per card), sees {n_cards}; "
            "not run (the 2-process path is held on gloo by "
            "tests/test_torch_distributed.py)")
        return launches
    tmp = tempfile.mkdtemp(prefix="chip_smoke_2p_")
    try:
        runs = {}
        for name, extra in (("clean", []),
                            ("kill", ["--ckpt-dir", os.path.join(tmp, "ck"),
                                      "--ckpt-every", "2",
                                      "--worker-kill-at", "step:3"])):
            out = os.path.join(tmp, name)
            cmd = [sys.executable, "-m", "repro_torch.launch.distributed",
                   "--num-processes", "2", "--spawn-workers",
                   "--device", "cuda", "--requests", str(CONT_N),
                   "--sizes", str(CONT_M), "--slots", str(CONT_B),
                   "--slow-every", str(CONT_SLOW_EVERY),
                   "--gamma", repr(CONT_GAMMA_FAST),
                   "--power-tol", repr(cfg.power_tol),
                   "--power-iters", str(cfg.power_iters),
                   "--check-every", str(cfg.power_check_every),
                   "--kernels", "--seed", str(SEED), "--outdir", out,
                   "--heartbeat-timeout", "120", *extra]
            env = dict(os.environ, PYTHONPATH=SRC)
            env.pop("MSC_DIST_KILL", None)
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=MH_CLI_TIMEOUT, env=env, cwd=HERE)
            wall = time.perf_counter() - t0
            ok = proc.returncode == 0
            _gate(checks, ok, label,
                  f"{name}: the CLI exits {proc.returncode} in {wall:.1f} s")
            if not ok:
                log(proc.stdout[-4000:])
                log(proc.stderr[-4000:])
                continue
            with np.load(os.path.join(out, "results.npz")) as z:
                res = [[_NpzMode(z, i, j) for j in range(3)]
                       for i in range(CONT_N)]
            with open(os.path.join(out, "stats.json")) as f:
                runs[name] = (res, json.load(f))
        for name, (res, st) in runs.items():
            same = _same_requests(res, ref, d_tol=3e-5)
            ft = (st["host_losses"], st["restores"], st["reinits"])
            want_ft = (1, 1, 1) if name == "kill" else (0, 0, 0)
            on_card = st["device"].startswith("cuda")
            c = st["control"]
            launches[f"{label} {name} (master)"] = {
                "power_iter": st["launches"]["power_iter"],
                "abs_rowsum": st["launches"]["abs_rowsum"],
                "batched_gram": 0, "flash_attention": 0}
            _gate(checks, same and ft == want_ft and on_card
                  and st["n_results"] == CONT_N
                  and st["launches"]["power_iter"] > 0
                  and st["launches"]["abs_rowsum"] > 0, label,
                  f"{name}: masks and sweeps of the one-device run (d "
                  f"within 3e-5): {same}; host losses / restores / reinits "
                  f"{ft} (want {want_ft}); the master ends on {st['device']}"
                  f"; mesh {st['mesh']}")
            log(f"  {name}: {c['ticks']} lockstep ticks, broadcast "
                f"{c['broadcast_s'] * 1e3 / max(c['ticks'], 1):.3f} ms and "
                f"acks {c['ack_s'] * 1e3 / max(c['ticks'], 1):.3f} ms a "
                f"tick, {c['wire_bytes'] / max(c['ticks'], 1):.0f} wire "
                f"bytes a tick; serve {st['serve_s'] * 1e3:.1f} ms cold "
                f"(15a cold: {cold_srv * 1e3:.1f} ms); recovery_s "
                f"{st['recovery_s']}; restored step {st['restored_step']}; "
                f"master launches {st['launches']} ({smi})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


class _NpzMode:
    """One mode of a result read back from the distributed CLI's
    results.npz."""

    def __init__(self, z, i, j):
        import torch

        self.mask = torch.from_numpy(z[f"mask_{i}_{j}"])
        self.d = torch.from_numpy(z[f"d_{i}_{j}"])
        self.power_iters_run = int(z[f"iters_{i}"][j])


# ------------------------------------------------------------ phase 16 --
# the MoE, SSM and hybrid archs at their published widths (random weights
# from seed 0), qwen2-moe-a2.7b last: ~57 GB of fp32 master weights
FAMILY_ARCHS = ("granite-moe-1b-a400m", "mamba2-2.7b", "recurrentgemma-2b",
                "qwen2-moe-a2.7b")
# the prefill against the no-cache forward: 300 tokens are two of
# mamba2's 256-token SSD chunks, the second padded
TWO_B, TWO_S = 2, 300
# recurrentgemma's no-cache forward through the kernel: two 2048 windows
RG_S = 4096


def phase_families(torch, checks, smi):
    """Phase 16: each of FAMILY_ARCHS served, its graphed decode against
    the eager loop, its prefill against its no-cache forward, and on
    recurrentgemma-2b the kernel route of that forward; 0 B left after
    each arch.  Returns {label: launch counts}."""
    import gc

    from repro_torch.serving.graphs import capture_stream

    t0 = time.perf_counter()
    log(f"MoE, SSM and hybrid archs at their published widths; card: {smi}")
    # what outlives the phase when it runs alone, made before the
    # baselines: the capture stream's and the default stream's cuBLAS
    # workspaces
    capture_stream(DEVICE)
    for dt in (torch.float32, torch.bfloat16):
        a = torch.ones((8, 8), dtype=dt, device=DEVICE)
        a @ a
    del a
    launches = {}
    for arch in FAMILY_ARCHS:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        launches.update(_family_runs(torch, checks, smi, arch))
        _freed(torch, checks, f"phase 16 {arch}", base)
    log(f"  phase 16 took {time.perf_counter() - t0:.1f} s")
    return launches


def _family_runs(torch, checks, smi, arch):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.inputs import make_batch
    from repro_torch.models import build_model, forward
    from repro_torch.models.transformer import logits_last

    label = f"lm serve {arch} pallas"
    out, counts = drive_lm(torch, label, [
        "--arch", arch, "--batch", str(LM_B), "--prompt-len", str(LM_PROMPT),
        "--gen", str(LM_GEN), "--device", DEVICE, "--attn-impl", "pallas"])
    peak = torch.cuda.max_memory_allocated()
    _gate(checks, not any(counts.values())
          and tuple(out["tokens"].shape) == (LM_B, LM_GEN), label,
          f"{arch} served in bf16: tokens {tuple(out['tokens'].shape)}, "
          f"kernel launches {counts} (want none: every self-attention here "
          f"has a KV cache), peak {peak} B ({peak / 2**30:.2f} GiB); {smi}")
    launches = {label: counts}
    del out

    cfg = get_config(arch)
    dev = torch.device(DEVICE)
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    for cdt, tol in (("bfloat16", 2e-2), ("float32", 1e-4)):
        model = build_model(dataclasses.replace(cfg, compute_dtype=cdt))
        batch = make_batch(model.cfg, LM_B, LM_PROMPT, kind="serve",
                           device=dev)
        STASH[f"p16 {arch} {cdt}"] = graphed_decode(
            torch, checks, model, params, batch, cdt, tol, label=f"{arch} ")

    # two algorithms, one function: the prefill (the recurrences step by
    # step, the SSD decode loop) against the no-cache forward (the chunked
    # SSD, the log-depth RG-LRU scan), fp32; MoE with a capacity no side
    # can overflow
    two = dataclasses.replace(cfg, compute_dtype="float32")
    if cfg.n_experts:
        two = dataclasses.replace(
            two, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    model = build_model(two)
    batch = make_batch(two, TWO_B, TWO_S, seed=1, kind="serve", device=dev)
    t = time.perf_counter()
    got, _ = model.prefill(params, batch, max_len=TWO_S + 1)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t
    t = time.perf_counter()
    with torch.no_grad():
        hidden, _, aux = forward(params, batch["tokens"], two)
        want = logits_last(params, hidden, two)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t
    rel = ((got - want).abs().max() / want.abs().max()).item()
    _gate(checks, bool(torch.isfinite(got).all()) and rel <= 2e-4,
          f"{arch} prefill vs forward",
          f"{arch} fp32 prefill's last logits against the no-cache forward "
          f"at ({TWO_B}, {TWO_S}): max rel diff {rel:.3e} (tol 2e-4); "
          f"prefill {t_pre * 1e3:.1f} ms, forward {t_fwd * 1e3:.1f} ms, "
          f"aux {aux.item():.6f}")
    del got, want, hidden, model, batch
    if arch == "recurrentgemma-2b":
        launches.update(_rg_kernel_route(torch, checks, smi, cfg, params))
    return launches


def _rg_kernel_route(torch, checks, smi, cfg, params):
    """recurrentgemma-2b's no-cache forward at B = 1, S = RG_S: its local
    layers through `flash_attention` (attn_impl="pallas") against the
    chunked route, fp32 then bf16: exactly one launch per local layer,
    both times, hidden states within 1e-4 of max |h| in fp32; in bf16
    within 2e-2, or within the chunked route's own bf16-to-fp32 distance
    where that is larger (26 layers over 4096 tokens carry a rounding
    flip far; that distance and the kernel route's are printed)."""
    import dataclasses

    from repro_torch.configs.inputs import make_batch
    from repro_torch.models import forward

    n_local = cfg.layer_kinds().count("local")
    tokens = make_batch(cfg, 1, RG_S, seed=2, kind="serve",
                        device=DEVICE)["tokens"]

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    launches, h32 = {}, None
    for cdt in ("float32", "bfloat16"):
        res = {}
        for impl in ("chunked", "pallas"):
            c = dataclasses.replace(cfg, compute_dtype=cdt, attn_impl=impl)
            with torch.no_grad():
                forward(params, tokens, c)  # warm
                mods = _reset_counts()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                h, _, _ = forward(params, tokens, c)
                end.record()
                end.synchronize()
            res[impl] = (h.float(), start.elapsed_time(end),
                         _read_counts(mods))
        (hp, ms_p, n_p), (hc, ms_c, n_c) = res["pallas"], res["chunked"]
        diff = rel(hp, hc)
        if cdt == "float32":
            h32, tol, text = hc, 1e-4, ""
        else:
            floor, own = rel(hc, h32), rel(hp, h32)
            tol = max(2e-2, floor)
            text = (f"; bf16 rounding alone: chunked bf16 vs chunked fp32 "
                    f"{floor:.3e}, kernel bf16 vs chunked fp32 {own:.3e}")
        label = f"recurrentgemma-2b forward S={RG_S} pallas {cdt}"
        launches[label] = n_p
        _gate(checks, bool(torch.isfinite(hp).all()) and diff <= tol
              and n_p["flash_attention"] == n_local
              and not any(n_c.values()), label,
              f"recurrentgemma-2b {cdt} no-cache forward at (1, {RG_S}), "
              f"kernel route against chunked: hidden max rel diff "
              f"{diff:.3e} (tol {tol:.3g}){text}; flash_attention launches "
              f"{n_p['flash_attention']} (want {n_local}, one per local "
              f"layer); forward {ms_p:.2f} ms (kernel) / {ms_c:.2f} ms "
              f"(chunked); {smi}")
        del res, hp, hc
    return launches


# ------------------------------------------------------------ phase 17 --
TRAIN_ARCH, MOE_TRAIN_ARCH = "qwen1.5-0.5b", "granite-moe-1b-a400m"
TRAIN_B, TRAIN_S = 8, 512
TRAIN_STEPS, TRAIN_CKPT, TRAIN_FAIL = 12, 6, 9
MOE_TRAIN_STEPS = 6
GRAD_B, GRAD_S, GRAD_LAYERS = 2, 128, 2


def phase_training(torch, checks, smi):
    """Phase 17: 17a, 17b and 17c under deterministic algorithms, the
    launch counts set to 0 before and read after.  Returns {label: launch
    counts}."""
    import gc

    t0 = time.perf_counter()
    log(f"training; card: {smi}")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(True)
    _warm_backward(torch)
    mods = _reset_counts()
    try:
        _train_resume(torch, checks, smi)
        _train_grads(torch, checks)
        _train_moe(torch, checks, smi)
    finally:
        torch.use_deterministic_algorithms(False)
    counts = _read_counts(mods)
    _gate(checks, not any(counts.values()), "train launches",
          f"kernel launches on the training path: {counts} (want none: "
          f"training takes the chunked attention)")
    log(f"  phase 17 took {time.perf_counter() - t0:.1f} s")
    return {"train 17a-17c": counts}


MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "router",
                  "lm_head")


def _model_flops(model, tokens: int, seq: int) -> float:
    """PaLM's model flops of a dense train step (no recompute counted): 6
    a token per matmul weight (the tied head's d x V included, the
    embedding lookup not) and 12 L d S a token for attention."""
    cfg = model.cfg
    n = sum(p.numel() for name, p in model.abstract().named_parameters()
            if name.rsplit(".", 1)[-1] in MATMUL_WEIGHTS)
    if cfg.tie_embeddings:
        n += cfg.vocab_size * cfg.d_model
    return tokens * (6 * n + 12 * cfg.n_layers * cfg.d_model * seq)


def _state_tensors(state):
    """Every tensor of a TrainState, in one fixed order."""
    out = list(state.params.parameters()) + [state.opt.step]
    out += list(state.opt.m.parameters()) + list(state.opt.v.parameters())
    if state.compress is not None:
        out += list(state.compress.residual.parameters())
    return out


def _warm_backward(torch):
    """What outlives the phase, made before its baselines: the cuBLAS
    workspaces of the default stream and of the autograd engine's device
    thread (it runs every backward, with a cuBLAS handle of its own)."""
    for dt in (torch.float32, torch.bfloat16):
        x = torch.ones((8, 8), dtype=dt, device=DEVICE, requires_grad=True)
        (x @ x).float().sum().backward()
    del x
    torch.cuda.synchronize()


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _timed_saves(loop):
    """Wrap `loop.ckpt` so each save records (snapshot s, write s,
    step): the snapshot is on the step path, the write in a thread."""
    ckpt, log_ = loop.ckpt, []
    save, write = ckpt.save, ckpt._write

    def timed_save(step, tree, extra=None):
        t = time.perf_counter()
        save(step, tree, extra)
        log_.append({"step": step, "snapshot_s": time.perf_counter() - t})

    def timed_write(step, host, extra):
        t = time.perf_counter()
        write(step, host, extra)
        for rec in log_:
            if rec["step"] == step:
                rec["write_s"] = time.perf_counter() - t

    ckpt.save, ckpt._write = timed_save, timed_write
    return log_


def _train_resume(torch, checks, smi):
    """17a: the crash-and-resume run against the uninterrupted run."""
    import gc
    import shutil
    import statistics
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models import build_model, count_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.training.loop import TrainLoop, TrainLoopConfig

    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    data = SyntheticLMDataset(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        crash = TrainLoop(model, None, AdamWConfig(), TrainLoopConfig(
            total_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT,
            ckpt_dir=os.path.join(tmp, "crash"), fail_at_step=TRAIN_FAIL),
            data, device=DEVICE)
        saves = _timed_saves(crash)
        t = time.perf_counter()
        s_crash = crash.run_with_restarts()
        torch.cuda.synchronize()
        wall_crash = time.perf_counter() - t
        ck_bytes = _dir_bytes(os.path.join(tmp, "crash",
                                           f"step_{TRAIN_STEPS:08d}"))
        shutil.rmtree(os.path.join(tmp, "crash"))
        peak = torch.cuda.max_memory_allocated()
        clean = TrainLoop(model, None, AdamWConfig(), TrainLoopConfig(
            total_steps=TRAIN_STEPS, ckpt_every=10 * TRAIN_STEPS,
            ckpt_dir=os.path.join(tmp, "clean")), data, device=DEVICE)
        t = time.perf_counter()
        s_clean = clean.run()
        torch.cuda.synchronize()
        wall_clean = time.perf_counter() - t
        with torch.no_grad():
            a, b = _state_tensors(s_crash), _state_tensors(s_clean)
            same = len(a) == len(b) and all(
                torch.equal(x, y) for x, y in zip(a, b))
            finite = all(bool(torch.isfinite(x).all())
                         for x in s_clean.params.parameters())
        del a, b, s_crash, s_clean
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = [m["loss"] for m in clean.metrics]
    got = [m["loss"] for m in crash.metrics]
    order = list(range(TRAIN_FAIL)) + list(range(TRAIN_CKPT, TRAIN_STEPS))
    _gate(checks, got == [want[i] for i in order] and same and finite
          and want[-1] < want[0] and all(map(math.isfinite, want)),
          "train resume",
          f"{TRAIN_ARCH} {TRAIN_STEPS} steps at ({TRAIN_B}, {TRAIN_S}), "
          f"bf16: crash at {TRAIN_FAIL} resumed from step {TRAIN_CKPT} "
          f"gives the uninterrupted losses bit for bit: "
          f"{got == [want[i] for i in order]}, final state bit for bit: "
          f"{same}; loss {want[0]:.6f} -> {want[-1]:.6f}")
    warm = [m["step_time_s"] for m in clean.metrics[1:]]
    step_ms = statistics.median(warm) * 1e3
    STASH["p17a"] = {"losses": want, "step_ms": step_ms, "peak": peak}
    flops = _model_flops(model, TRAIN_B * TRAIN_S, TRAIN_S)
    share = flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    log(f"  {TRAIN_ARCH}: {count_params(model.defs())} parameters; warm step "
        f"{step_ms:.2f} ms (median of {len(warm)}; first "
        f"{clean.metrics[0]['step_time_s'] * 1e3:.1f} ms), "
        f"{TRAIN_B * TRAIN_S / (step_ms / 1e3):.0f} tokens/s, model flops "
        f"{flops:.4e} a step = {share:.4f} of 989 TFLOP/s; peak "
        f"{peak} B ({peak / 2**30:.2f} GiB); walls crash+resume "
        f"{wall_crash:.2f} s, clean {wall_clean:.2f} s; {smi}")
    for rec in saves:
        log(f"  checkpoint step {rec['step']}: snapshot to host "
            f"{rec['snapshot_s'] * 1e3:.1f} ms on the step path, write + "
            f"SHA-256 {rec.get('write_s', float('nan')) * 1e3:.1f} ms in "
            f"its thread")
    log(f"  checkpoint bytes {ck_bytes}; failure to first resumed step "
        f"{crash.restart_s[0]:.3f} s; stragglers {crash.straggler_events} / "
        f"{clean.straggler_events}")
    del crash, clean
    _freed(torch, checks, "train 17a memory", base)


def _train_grads(torch, checks):
    """17b: the card's loss and gradients against the CPU's, fp32."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset, device_put_batch
    from repro_torch.models import build_model, map_params, trainable

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=GRAD_LAYERS,
                              compute_dtype="float32")
    model = build_model(cfg)
    host = trainable(model.init(torch.Generator().manual_seed(0)))
    card = trainable(map_params(lambda p: p.detach().to(DEVICE), host))
    batch = SyntheticLMDataset(cfg.vocab_size, GRAD_S, GRAD_B,
                               seed=1).batch(0)
    out = {}
    for name, params in (("cpu", host), ("card", card)):
        dev = "cpu" if name == "cpu" else DEVICE
        loss, _ = model.loss_fn(params, device_put_batch(batch, dev))
        grads = torch.autograd.grad(loss, list(params.parameters()))
        out[name] = (loss.item(), [g.cpu() for g in grads])
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out["card"]
    names = [n for n, _ in host.named_parameters()]
    worst, where = 0.0, None
    for n, a, b in zip(names, g_card, g_cpu):
        err = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        if err > worst:
            worst, where = err, n
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    _gate(checks, rel <= 1e-4 and worst <= 1e-4, "train grads card vs cpu",
          f"{TRAIN_ARCH} width, {GRAD_LAYERS} layers, fp32, TF32 off, "
          f"({GRAD_B}, {GRAD_S}): loss {l_card:.6f} card / {l_cpu:.6f} CPU "
          f"(rel {rel:.3e}); worst gradient leaf {where} {worst:.3e} of its "
          f"largest |g| over {len(names)} leaves (tol 1e-4)")


def _train_moe(torch, checks, smi):
    """17c: granite-moe at its published size, 1 and 2 microbatches."""
    import gc
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset, device_put_batch
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training.steps import build_train_step, make_train_state

    cfg = get_config(MOE_TRAIN_ARCH)
    model = build_model(cfg)
    data = SyntheticLMDataset(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0)
    first = {}
    for n_mb in (1, 2):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = make_train_state(
            model, torch.Generator(device=DEVICE).manual_seed(0))
        step, _, _ = build_train_step(model, None, AdamWConfig(),
                                      microbatches=n_mb)
        losses, auxes, times = [], [], []
        for i in range(MOE_TRAIN_STEPS):
            batch = device_put_batch(data.batch(i), DEVICE)
            t = time.perf_counter()
            state, met = step(state, batch)
            losses.append(met["loss"].item())
            auxes.append(met["aux"].item())
            times.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated()
        del state
        first[n_mb] = losses[0]
        ms = statistics.median(times[1:]) * 1e3
        STASH[f"p17c {n_mb}"] = {"losses": losses, "step_ms": ms,
                                 "peak": peak}
        _gate(checks, all(map(math.isfinite, losses + auxes))
              and losses[-1] < losses[0], f"train moe n_mb={n_mb}",
              f"{MOE_TRAIN_ARCH} bf16 ({TRAIN_B}, {TRAIN_S}), {n_mb} "
              f"microbatch(es): loss {losses[0]:.6f} -> {losses[-1]:.6f}, "
              f"aux {auxes[0]:.6f} -> {auxes[-1]:.6f}; warm step {ms:.2f} ms "
              f"(median of {len(times) - 1}), "
              f"{TRAIN_B * TRAIN_S / (ms / 1e3):.0f} tokens/s, peak {peak} B "
              f"({peak / 2**30:.2f} GiB); {smi}")
    rel = abs(first[2] - first[1]) / abs(first[1])
    _gate(checks, rel <= 1e-2, "train moe microbatches",
          f"{MOE_TRAIN_ARCH} step-1 loss with 2 microbatches {first[2]:.6f} "
          f"against 1: {first[1]:.6f} (rel {rel:.3e}, tol 1e-2)")


# ------------------------------------------------------------ phase 18 --
# the LM over ranks on a (data, model) = (1, 1) mesh of one NCCL rank
MESH_TRAIN_STEPS, MESH_MOE_STEPS = 3, 2
MESH_SERVE_ARCHS = ("granite-moe-1b-a400m", "mamba2-2.7b",
                    "recurrentgemma-2b")


def phase_lm_ranks(torch, checks, smi):
    """Phase 18: 18a and 18b (training, under deterministic algorithms,
    kernel launch counts set to 0 before and read after) and 18c
    (serving) on a (1, 1) mesh of one NCCL rank, each against the
    one-device path on the same weights; 0 B left after each.  Returns
    {label: launch counts}."""
    import gc
    import tempfile

    from repro_torch.launch.mesh import join, leave, make_local_mesh
    from repro_torch.serving.graphs import capture_stream

    t0 = time.perf_counter()
    log(f"the LM over ranks: a (data, model) = (1, 1) mesh of one NCCL "
        f"rank; card: {smi}")
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        join("cuda", rank=0, world_size=1,
             store_file=os.path.join(tmp, "store"))
        try:
            mesh = make_local_mesh(1)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.use_deterministic_algorithms(True)
            _warm_backward(torch)
            base = torch.cuda.memory_allocated()
            mods = _reset_counts()
            _ranks_train(torch, checks, smi, mesh, tmp)
            _ranks_moe(torch, checks, smi, mesh)
            counts = _read_counts(mods)
            torch.use_deterministic_algorithms(False)
            _gate(checks, not any(counts.values()), "train ranks launches",
                  f"kernel launches on the training path over ranks: "
                  f"{counts} (want none: training takes the chunked "
                  f"attention)")
            launches["train 18a-18b (1, 1)"] = counts
            _freed(torch, checks, "phase 18a-18b memory", base)
            # what outlives the serving runs when this phase runs alone,
            # made before their baselines (as phase 16 does): the capture
            # stream's and the default stream's cuBLAS workspaces
            capture_stream(DEVICE)
            for dt in (torch.float32, torch.bfloat16):
                a = torch.ones((8, 8), dtype=dt, device=DEVICE)
                a @ a
            del a
            for arch in MESH_SERVE_ARCHS:
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                launches.update(_ranks_serve(torch, checks, smi, mesh, arch))
                _freed(torch, checks, f"phase 18c {arch} memory", base)
        finally:
            torch.use_deterministic_algorithms(False)
            leave()
    log(f"  phase 18 took {time.perf_counter() - t0:.1f} s")
    return launches


def _or_not_run(value, fmt: str, unit: str) -> str:
    """A number from an earlier phase, or "not run" when that phase did
    not run in this invocation."""
    return "not run" if value is None else format(value, fmt) + unit


def _bits_equal(torch, a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _ranks_steps(torch, model, mesh, data, n, routes=False):
    """n train steps of `model` from seed 0 on one device (mesh None) or on
    the mesh.  Returns (state, losses, step seconds, peak bytes above the
    start, the step function, (topi, keep) of step 1 when `routes`)."""
    from repro_torch.data.pipeline import device_put_batch
    from repro_torch.models.layers import record_routes
    from repro_torch.optim import AdamWConfig
    from repro_torch.training.steps import build_train_step, make_train_state

    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(
        model, torch.Generator(device=DEVICE).manual_seed(0), mesh=mesh)
    step, _, bspecs = build_train_step(model, mesh, AdamWConfig())
    losses, times, seen = [], [], None
    for i in range(n):
        batch = device_put_batch(data.batch(i), DEVICE,
                                 bspecs if mesh is not None else None,
                                 step.shards)
        t = time.perf_counter()
        if routes and i == 0:
            with record_routes() as seen:
                state, met = step(state, batch)
        else:
            state, met = step(state, batch)
        losses.append(met["loss"].item())
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() - start
    return state, losses, times, peak, step, seen


def _ranks_train(torch, checks, smi, mesh, tmp):
    """18a: qwen1.5-0.5b, MESH_TRAIN_STEPS steps at (TRAIN_B, TRAIN_S) in
    bf16 on fp32 masters, on one device and on the (1, 1) mesh: the same
    losses and state bit for bit; a crash at step 2 after the step-1
    checkpoint, resumed on the mesh, the uninterrupted mesh run's bits;
    that checkpoint resumed on one device, the same bits again."""
    import statistics

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset, device_put_batch
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training.loop import TrainLoop, TrainLoopConfig
    from repro_torch.training.steps import (abstract_train_state,
                                            build_train_step)

    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    data = SyntheticLMDataset(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0)
    n = MESH_TRAIN_STEPS
    s_one, l_one, t_one, p_one, _, _ = _ranks_steps(torch, model, None,
                                                     data, n)
    s_mesh, l_mesh, t_mesh, p_mesh, step, _ = _ranks_steps(torch, model,
                                                          mesh, data, n)
    a, b = _state_tensors(s_one), _state_tensors(s_mesh)
    same = _bits_equal(torch, a, b)
    worst = max(((x.float() - y.float()).abs().max()
                 / x.float().abs().max().clamp_min(1e-30)).item()
                for x, y in zip(a, b))
    del a, b
    p17 = STASH.get("p17a")
    against17 = ("phase 17a not run" if p17 is None else
                 f"phase 17a's first {n}: {p17['losses'][:n] == l_one}")
    _gate(checks, same and l_one == l_mesh, "train ranks 18a",
          f"{TRAIN_ARCH} ({TRAIN_B}, {TRAIN_S}) bf16 on fp32 masters, {n} "
          f"steps: the (1, 1) mesh's losses and every state tensor "
          f"bit for bit the one-device run's: {same and l_one == l_mesh} "
          f"(worst state tensor {worst:.3e} of its largest |x|; losses "
          f"{l_mesh}; one-device losses equal {against17})")
    ms_one = statistics.median(t_one[1:]) * 1e3
    ms_mesh = statistics.median(t_mesh[1:]) * 1e3
    tok = TRAIN_B * TRAIN_S
    log(f"  step {ms_mesh:.2f} ms on (1, 1) against {ms_one:.2f} ms on one "
        f"device (median of steps 2..{n}; phase 17a: "
        f"{_or_not_run(p17 and p17['step_ms'], '.2f', ' ms')}"
        f"), {tok / ms_mesh * 1e3:.0f} against {tok / ms_one * 1e3:.0f} "
        f"tokens/s; peak above the run's start {p_mesh} B against {p_one} B; "
        f"{smi}")
    log(f"  collectives a step on (1, 1): {dict(step.shards.counts)}, of "
        f"which gradient reductions {dict(step.shards.grad_counts)}")
    del s_one

    # a crash at step 2 after the checkpoint at step 1, resumed on (1, 1)
    ck = os.path.join(tmp, "ck18a")
    loop = TrainLoop(model, mesh, AdamWConfig(), TrainLoopConfig(
        total_steps=n, ckpt_every=1, ckpt_dir=ck, fail_at_step=1), data,
        device=DEVICE)
    s_crash = loop.run_with_restarts()
    got = [m["loss"] for m in loop.metrics]
    same_c = got == l_mesh and _bits_equal(
        torch, _state_tensors(s_crash), _state_tensors(s_mesh))
    _gate(checks, same_c, "train ranks 18a resume",
          f"crash at step 2 after the step-1 checkpoint, resumed on (1, 1): "
          f"the uninterrupted (1, 1) run's losses and state bit for bit: "
          f"{same_c}; failure to first resumed step "
          f"{loop.restart_s[0]:.3f} s")
    del s_crash, loop
    # the step-1 checkpoint on one device, then steps 2..n there
    state, _ = restore_checkpoint(ck, 1, abstract_train_state(model), DEVICE)
    one_step, _, _ = build_train_step(model, None, AdamWConfig())
    for i in range(1, n):
        state, _ = one_step(state, device_put_batch(data.batch(i), DEVICE))
    same_r = _bits_equal(torch, _state_tensors(state), _state_tensors(s_mesh))
    _gate(checks, same_r, "train ranks 18a restore on one device",
          f"the (1, 1) mesh's step-1 checkpoint resumed on one device: after "
          f"step {n} the (1, 1) run's state bit for bit: {same_r}")
    del state, s_mesh


def _ranks_moe(torch, checks, smi, mesh):
    """18b: granite-moe-1b-a400m, MESH_MOE_STEPS steps on the (1, 1) mesh:
    the step-1 loss within 1e-5 relative of the one-device step's (phase
    17c's path) and every routing decision of step 1 identical."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models import build_model

    cfg = get_config(MOE_TRAIN_ARCH)
    model = build_model(cfg)
    data = SyntheticLMDataset(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0)
    s, l_one, _, _, _, r_one = _ranks_steps(torch, model, None, data, 1,
                                            routes=True)
    del s
    s, l_mesh, t_mesh, peak, step, r_mesh = _ranks_steps(
        torch, model, mesh, data, MESH_MOE_STEPS, routes=True)
    del s
    same = len(r_one) == len(r_mesh) and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        for a, b in zip(r_one, r_mesh))
    rel = abs(l_mesh[0] - l_one[0]) / abs(l_one[0])
    p17 = STASH.get("p17c 1")
    _gate(checks, rel <= 1e-5 and same and all(map(math.isfinite, l_mesh)),
          "train ranks 18b",
          f"{MOE_TRAIN_ARCH} ({TRAIN_B}, {TRAIN_S}) bf16 on (1, 1): step-1 "
          f"loss {l_mesh[0]:.6f} against one device {l_one[0]:.6f} (rel "
          f"{rel:.3e}, tol 1e-5; phase 17c: "
          f"{'not run' if p17 is None else repr(p17['losses'][0])}); "
          f"routing decisions of step 1 identical over {len(r_mesh)} "
          f"routings (forward and remat recompute): {same}; losses {l_mesh}")
    ms = statistics.median(t_mesh[1:]) * 1e3
    log(f"  step {ms:.2f} ms on (1, 1) ({TRAIN_B * TRAIN_S / ms * 1e3:.0f} "
        f"tokens/s; phase 17c: "
        f"{_or_not_run(p17 and p17['step_ms'], '.2f', ' ms')}"
        f"), peak above the run's start {peak} B; collectives a step "
        f"{dict(step.shards.counts)}, of which gradient reductions "
        f"{dict(step.shards.grad_counts)}; {smi}")


def _ranks_serve(torch, checks, smi, mesh, arch):
    """18c: `arch` served in fp32 on the (1, 1) mesh at phase 16's batch
    and lengths: the one-device engine's tokens, one decode graph a step
    (captured once cold, none warm); on recurrentgemma-2b the (1, RG_S)
    no-cache forward with attn_impl="pallas" on the mesh: one
    flash_attention launch per local layer, within 2e-4 of max |h| of the
    one-device forward."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.inputs import make_batch
    from repro_torch.models import build_model, forward
    from repro_torch.serving.engine import (ServeEngine, build_serve_steps,
                                            shard_params)
    from repro_torch.sharding.activation import activation_sharding

    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    model = build_model(cfg)
    dev = torch.device(DEVICE)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    batch = make_batch(cfg, LM_B, LM_PROMPT, kind="serve", device=dev)
    max_len = LM_PROMPT + LM_GEN
    out = {}
    for name, m in (("one", None), ("mesh", mesh)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = ServeEngine(model, params, LM_B, max_len, mesh=m)
        eng.generate(batch, LM_GEN)  # cold: one eager step, the capture
        first = eng._decode
        toks = eng.generate(batch, LM_GEN)  # warm: replays
        out[name] = (toks, eng.timings["decode_ms"] / LM_GEN,
                     eng.captures == 1 and eng._decode is first,
                     torch.cuda.max_memory_allocated())
        eng.close()
        del eng
    (t1, ms1, once1, _), (t2, ms2, once2, peak) = out["one"], out["mesh"]
    p16 = STASH.get(f"p16 {arch} float32")
    _gate(checks, torch.equal(t1, t2) and once1 and once2,
          f"serve ranks {arch}",
          f"{arch} fp32 ({LM_B}, {LM_PROMPT}) + {LM_GEN} on (1, 1): tokens "
          f"== the one-device engine's {torch.equal(t1, t2)}; decode one "
          f"CUDA graph a step (captured once cold, none warm): {once2}; "
          f"warm decode {ms2:.3f} ms a token against {ms1:.3f} on one device "
          f"(phase 16: "
          f"{_or_not_run(p16 and p16['graphed_ms_per_token'], '.3f', ' ms')}"
          f"); peak {peak} B; {smi}")
    launches = {}
    if arch == "recurrentgemma-2b":
        c = dataclasses.replace(cfg, attn_impl="pallas")
        tokens = make_batch(c, 1, RG_S, seed=2, kind="serve",
                            device=dev)["tokens"]
        with torch.no_grad():
            want, _, _ = forward(params, tokens, c)
            _, _, _, _, p_specs, shards = build_serve_steps(
                build_model(c), mesh, 1, RG_S)
            local = shard_params(build_model(c), params, shards, p_specs, dev)
            mods = _reset_counts()
            with activation_sharding(shards):
                got, _, _ = forward(local, tokens, c)
            counts = _read_counts(mods)
        rel = ((got - want).abs().max() / want.abs().max()).item()
        n_local = cfg.layer_kinds().count("local")
        label = f"recurrentgemma-2b forward S={RG_S} pallas (1, 1)"
        launches[label] = counts
        _gate(checks, rel <= 2e-4 and counts["flash_attention"] == n_local,
              label,
              f"recurrentgemma-2b fp32 no-cache forward at (1, {RG_S}) with "
              f"attn_impl='pallas' on (1, 1): hidden max rel diff "
              f"{rel:.3e} against one device (tol 2e-4); flash_attention "
              f"launches {counts['flash_attention']} (want {n_local})")
        del got, want, local
    return launches


# ------------------------------------------------------------ phase 19 --
# the dry run's trace of phase 17's step against the step on the card, and
# the dry-run CLI on the card's host: (label, argv, reports it writes)
DRY_CLIS = (
    ("qwen train_4k", ["--arch", "qwen1.5-0.5b", "--shape", "train_4k",
                       "--pods", "both"], 2),
    ("mamba2 decode_32k", ["--arch", "mamba2-2.7b", "--shape",
                           "decode_32k"], 1),
    ("msc 1024", ["--msc", "1024", "--msc-gram", "--pods", "both"], 4),
)
DRY_CLI_TIMEOUT_S = 300


def phase_dryrun(torch, checks, smi):
    """Phase 19: 19a, the trace of one qwen1.5-0.5b train step at phase
    17's (8, 512) against the step on the card (FLOPs and argument bytes
    exact); 19b, the dry-run CLI on three cells, run in child processes
    beside 19a: every cell ok, a report a cell with its HBM note, no CUDA
    set up and neither jax nor the reference imported.  Returns {label:
    launch counts}."""
    import tempfile

    t0 = time.perf_counter()
    log(f"dry run; card: {smi}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        procs = [(label, n, os.path.join(tmp, str(i)), _start_dry_cli(
            argv + ["--out-dir", os.path.join(tmp, str(i))]))
            for i, (label, argv, n) in enumerate(DRY_CLIS)]
        try:
            mods = _reset_counts()
            _dry_step(torch, checks, smi)
            counts = _read_counts(mods)
            for label, n, out_dir, proc in procs:
                _dry_cli(checks, label, n, out_dir, proc)
        finally:
            for *_, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
    _gate(checks, not any(counts.values()), "dry-run launches",
          f"kernel launches on the traced step's path: {counts} (want none)")
    log(f"  phase 19 took {time.perf_counter() - t0:.1f} s")
    return {"dry run 19a": counts}


def _start_dry_cli(argv):
    """`python -m repro_torch.launch.dryrun argv` in a child process that
    also fails if the run set up CUDA or imported jax or the reference."""
    code = ("import sys, torch\n"
            "from repro_torch.launch import dryrun\n"
            f"rc = dryrun.main({argv!r})\n"
            "if torch.cuda.is_initialized():\n"
            "    sys.exit('the dry run set up CUDA')\n"
            "if {'jax', 'repro'} & set(sys.modules):\n"
            "    sys.exit('the dry run imported jax or the reference')\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-c", code], env=env, cwd=HERE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _dry_cli(checks, label, n, out_dir, proc):
    """19b: one CLI run's exit code, summary line and reports."""
    try:
        out, err = proc.communicate(timeout=DRY_CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    want = f"=== dry-run complete: {n} cells ok, 0 failed ==="
    reps = []
    if os.path.isdir(out_dir):
        for name in sorted(os.listdir(out_dir)):
            with open(os.path.join(out_dir, name)) as f:
                reps.append(json.load(f))
    for r in reps:
        ms = r["memory_stats"]
        need = ms["argument_size_in_bytes"] + ms["temp_size_in_bytes"]
        log(f"    {r['arch']} {r['shape']} {r['mesh']}: args+temp {need:.4e} "
            f"B of 80e9 ({r['note'].split()[-1]}), dominant {r['dominant']}, "
            f"bound {r['bound_s'] * 1e3:.3f} ms, model/traced flops "
            f"{r['flops_ratio']:.4f}")
    notes_ok = all(
        r["hw"] == "nvidia-h100-sxm" and r["note"].split()[-1] == (
            "fits-hbm" if r["memory_stats"]["argument_size_in_bytes"]
            + r["memory_stats"]["temp_size_in_bytes"] <= 80e9
            else "EXCEEDS-HBM") for r in reps)
    ok = proc.returncode == 0 and want in out and len(reps) == n and notes_ok
    _gate(checks, ok, f"dry-run CLI {label}",
          f"dry-run CLI {label}: exit {proc.returncode}, {len(reps)} reports "
          f"(want {n}), notes against 80e9 B: {notes_ok}; no CUDA set up, "
          f"no jax")
    if not ok:
        log(out[-3000:] + err[-3000:])


def _dry_step(torch, checks, smi):
    """19a: one warm train step on the card against the dry run's trace of
    the same step on one device."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.configs.inputs import make_batch
    from repro_torch.launch import dryrun
    from repro_torch.models import ShapeConfig, build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.roofline import H100, model_flops, report_from_compiled
    from repro_torch.roofline.trace import flop_counter, storage_bytes
    from repro_torch.training.steps import build_train_step, make_train_state

    cfg = get_config(TRAIN_ARCH)
    shape = ShapeConfig(f"train_{TRAIN_B}x{TRAIN_S}", TRAIN_S, TRAIN_B,
                        "train")
    t = time.perf_counter()
    trace, _, _ = dryrun.lower_cell(TRAIN_ARCH, shape, None)
    trace_s = time.perf_counter() - t
    rep = report_from_compiled(trace, arch=TRAIN_ARCH, shape_name=shape.name,
                               mesh_name="1", chips=1, hw=H100,
                               model_fl=model_flops(cfg, shape, "train"))
    model = build_model(cfg)
    _warm_backward(torch)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = make_train_state(model, torch.Generator(device=DEVICE)
                             .manual_seed(0))
    batch = make_batch(cfg, TRAIN_B, TRAIN_S, device=DEVICE)
    step, _, _ = build_train_step(model, None, AdamWConfig(),
                                  global_batch=TRAIN_B, seq_len=TRAIN_S)
    args = storage_bytes((state, batch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    with flop_counter() as fc:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    flops = fc.get_total_flops()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, metrics = step(state, batch)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    step_ms = sorted(times)[1]
    _gate(checks, flops == trace.flops and args == trace.argument_bytes,
          "dry-run step",
          f"{TRAIN_ARCH} train step at ({TRAIN_B}, {TRAIN_S}) on one device: "
          f"traced flops {trace.flops:.0f} (trace {trace_s:.1f} s on the "
          f"host), the card's step {flops} under FlopCounterMode; argument "
          f"bytes {trace.argument_bytes:.0f} traced, {args} on the card")
    log(f"  peak: reckoned args + traced temp "
        f"{trace.argument_bytes + trace.peak_bytes:.0f} B, the card's first "
        f"step torch.cuda.max_memory_allocated {peak} B; H100 bound "
        f"{rep.bound_s * 1e3:.3f} ms ({rep.dominant}: compute "
        f"{rep.compute_s * 1e3:.3f}, memory {rep.memory_s * 1e3:.3f} ms) "
        f"beside the measured warm step {step_ms:.2f} ms (median of 3, "
        f"CUDA events); {smi}")
    del state, batch, step, metrics
    _freed(torch, checks, "dry-run 19a memory", base)


# ------------------------------------------------------------ phase 20 --
# the MSC schedule's stages in isolation (`core/schedule.py:
# build_epilogue_rowsum`, `build_mode_runner`) on one NCCL rank, their
# traced forms (`launch/dryrun.py:lower_epilogue`, `lower_mode_stage`)
# on fake groups on the host, and (20c) both stages over every card
STAGE_EPILOGUES = ("allgather", "ring")
STAGE_TOL = 1e-4          # phase 3's abs_rowsum fp32 tolerance (of max |d|)
STAGE_REPS = (20, 5)      # CUDA-event times a median: epilogue, mode stage
STAGE_PEAK_TOL = 0.03     # reckoned peak against the card's
STAGE_D_TOL = 3e-5        # 20c's d and λ against one rank's (relative)
RANKS_TESTS = (
    "tests/test_torch_lm_mesh.py::test_lm_serving_across_nccl_ranks",
    "tests/test_torch_lm_mesh.py::test_training_across_nccl_ranks",
    "tests/test_torch_lm_mesh.py::test_training_cli_resumes_across_nccl_ranks")
# the pytest run of RANKS_TESTS: the sum of the tests' own bounds
# (tests/test_torch_lm_mesh.py: SERVE_JOIN, TRAIN_JOIN, 2 × CLI_TIMEOUT)
RANKS_TIMEOUT_S = 300 + 400 + 2 * 400


def _median_ms(torch, fn, reps):
    """The median of `reps` CUDA-event times of fn, after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def phase_stages(torch, checks, smi):
    """Phase 20: the traced stages on the host, 20a and 20b on a (1,) mesh
    of one NCCL rank, 20c over every card when there are two or more; 0 B
    left once the group and the tensors are freed.  Returns {label:
    launch counts}."""
    import gc
    import tempfile

    from repro_torch.launch.mesh import join, leave, make_msc_mesh

    t0 = time.perf_counter()
    log(f"the MSC stages in isolation; card: {smi}")
    trace = _stage_traces()  # fake groups: before this process joins one
    # the default stream's cuBLAS workspace (the plain epilogue's product)
    # outlives the phase: made before the baseline when it runs alone
    a = torch.ones((8, 8), device=DEVICE)
    a @ a
    del a
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    launches, keep = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stages_") as tmp:
        try:
            join("cuda", rank=0, world_size=1,
                 store_file=os.path.join(tmp, "store"))
            mesh = make_msc_mesh("flat", (1,))
            launches["stages 20a"] = _stage_epilogues(torch, checks, mesh,
                                                      keep)
            launches["stages 20b"] = _stage_mode(torch, checks, mesh, trace,
                                                 keep)
        finally:
            leave()
        _stage_ranks(torch, checks, tmp, keep)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - base
    _gate(checks, left == 0, "phase 20 memory",
          f"{left} B left once the process group and the tensors are freed")
    log(f"  phase 20 took {time.perf_counter() - t0:.1f} s")
    return launches


def _stage_traces():
    """The traced stages on fake process groups on the host (no device):
    both epilogues at the reference benchmark's p = 4, 8, 32 and m = c =
    1000, the mode stage at its p = 4, m = 96, q = 1, 2, 4, 8, each beside
    the H100 models' numbers; then the mode stage at 20b's cell (m = 1000,
    (1,), kernels on), returned."""
    from repro_torch.core import MSCConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import _mesh
    from repro_torch.roofline import eigensolve_model, epilogue_model
    from repro_torch.roofline.trace import fake_world

    for p in (4, 8, 32):
        with fake_world(p):
            mesh = _mesh((p,), ("slice",), "cpu")
            traces = {e: dryrun.lower_epilogue(M, M, mesh,
                                               MSCConfig(epilogue=e))
                      for e in STAGE_EPILOGUES}
        for e, t in traces.items():
            kind = dryrun.EPILOGUE_KINDS[e]
            k = t.by_kind()[kind]
            pred = epilogue_model(M, M, p, epilogue=e)
            log(f"  traced {e} epilogue, p = {p}, m = c = {M} fp32: "
                f"{int(k['count'])} {kind}, link {k['link_bytes']:.0f} B "
                f"(model {pred['link_bytes']:.0f}), landing buffer "
                f"{dryrun.landing_bytes(t, e):.0f} B (model "
                f"{pred['peak_buffer_bytes']:.0f}), temp {t.peak_bytes:.0f} "
                f"B; other kinds {sorted(set(t.by_kind()) - {kind})}")
    for q in (1, 2, 4, 8):
        with fake_world(4 * q):
            mesh = _mesh((4, q), ("slice", "inner"), "cpu")
            t = dryrun.lower_mode_stage(96, mesh, MSCConfig())
        pred = eigensolve_model(96, 96, 96, 4, q, sweeps=60)
        ar = t.by_kind().get("all-reduce", {})
        log(f"  traced mode stage, (slice, inner) = (4, {q}), m = 96, 60 "
            f"sweeps: argument {t.argument_bytes:.0f} B (model block "
            f"{pred['block_bytes_per_device']:.0f} + the mask), temp "
            f"{t.peak_bytes:.0f} B, {int(ar.get('count', 0))} all-reduces, "
            f"link {ar.get('link_bytes', 0.0):.0f} B (model inner sums "
            f"{pred['psum_link_bytes']:.0f})")
    with fake_world(1):
        mesh = _mesh((1,), ("slice",), "cpu")
        t = dryrun.lower_mode_stage(M, mesh,
                                    main_cfg().with_(use_kernels=True))
    log(f"  traced mode stage, (1,), m = {M}: argument "
        f"{t.argument_bytes:.0f} B, temp {t.peak_bytes:.0f} B, "
        f"collectives {t.counts()}")
    return t


def _stage_epilogues(torch, checks, mesh, keep):
    """20a: both epilogues at m = c = 1000 fp32 with kernels (abs_rowsum),
    each against the same stage on its plain version; the gathered d
    whole; max |Δd| between them and the median times."""
    from repro_torch.core import MSCConfig, build_epilogue_rowsum

    v = torch.randn((M, M), generator=torch.Generator(device=DEVICE)
                    .manual_seed(SEED), device=DEVICE)
    keep["v"] = v.cpu()
    total = dict.fromkeys(KERNELS, 0)
    d = {}
    for epi in STAGE_EPILOGUES:
        stage = build_epilogue_rowsum(mesh, MSCConfig(epilogue=epi,
                                                      use_kernels=True))
        plain = build_epilogue_rowsum(mesh, MSCConfig(epilogue=epi))
        rows = stage.rows(v)
        torch.cuda.synchronize()
        mods = _reset_counts()
        d[epi] = stage(rows)
        torch.cuda.synchronize()
        counts = _read_counts(mods)
        for n, c in counts.items():
            total[n] += c
        _gate(checks, counts["abs_rowsum"] == 1 and sum(counts.values())
              == 1, f"stage 20a {epi}",
              f"20a {epi} epilogue, one rank: launches {counts} (want one "
              f"abs_rowsum)")
        checks.compare("abs_rowsum", f"stage 20a {epi} epilogue, (1,) mesh, "
                       f"V ({M}, {M}) fp32", (d[epi],), (plain(rows),),
                       STAGE_TOL)
        whole = stage.gather(d[epi], M)
        _gate(checks, torch.equal(whole, d[epi]), f"stage 20a {epi}",
              f"20a {epi}: the gathered d is the rank's d")
        ms = _median_ms(torch, lambda: stage(rows), STAGE_REPS[0])
        plain_ms = _median_ms(torch, lambda: plain(rows), STAGE_REPS[0])
        log(f"  20a {epi}: {ms:.4f} ms with abs_rowsum, {plain_ms:.4f} ms "
            f"plain (median of {STAGE_REPS[0]}, CUDA events)")
        keep[epi] = d[epi].cpu()
    diff = (d["allgather"] - d["ring"]).abs().max().item()
    log(f"  20a max |d_allgather - d_ring| = {diff:.3e} (max d "
        f"{d['ring'].abs().max().item():.4e})")
    return total


def _stage_mode(torch, checks, mesh, trace, keep):
    """20b: the mode runner on mode 0 of the main path's tensor (kernels
    on) against the flat schedule's mode 0 on the same group, bit for
    bit; the traced argument bytes exact and the reckoned peak within 3%
    of the card's; the median time."""
    import gc

    from repro_torch.core import build_msc_parallel
    from repro_torch.core.msc import mode_slices
    from repro_torch.core.parallel import _flat_schedule
    from repro_torch.core.schedule import build_mode_runner
    from repro_torch.roofline.trace import storage_bytes

    cfg = main_cfg().with_(use_kernels=True)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    tensor = _planted(torch, SEED, M, GAMMA)
    sched = _flat_schedule(cfg, mesh)
    run = build_mode_runner(sched)
    block, valid = sched.local_block(mode_slices(tensor, 0))
    args = storage_bytes((block, valid))
    run(block, valid)  # warm: the kernels' first calls set them up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mods = _reset_counts()
    d, lam, iters = run(block, valid)
    torch.cuda.synchronize()
    counts = _read_counts(mods)
    peak = torch.cuda.max_memory_allocated() - base
    ms = _median_ms(torch, lambda: run(block, valid), STAGE_REPS[1])
    flat = build_msc_parallel(cfg, "flat", mesh=mesh)(tensor)[0]
    same = (torch.equal(d, flat.d) and torch.equal(lam, flat.lambdas)
            and int(iters.max()) == int(flat.power_iters_run))
    reckoned = trace.argument_bytes + trace.peak_bytes
    _gate(checks, counts["power_iter"] > 0 and counts["abs_rowsum"] > 0
          and not counts["batched_gram"] and not counts["flash_attention"],
          "stage 20b", f"20b launches {counts} (want power_iter and "
          f"abs_rowsum)")
    _gate(checks, same, "stage 20b",
          f"20b d, λ and sweeps ({int(iters.max())}) of the mode runner "
          f"bit-identical to the flat schedule's mode 0 on the same group")
    _gate(checks, args == trace.argument_bytes, "stage 20b",
          f"20b argument bytes: traced {trace.argument_bytes:.0f}, the "
          f"card's block and mask {args}")
    _gate(checks, abs(reckoned - peak) <= STAGE_PEAK_TOL * peak,
          "stage 20b", f"20b peak: reckoned args + traced temp "
          f"{reckoned:.0f} B, the card's max_memory_allocated over the call "
          f"{peak} B ({(reckoned - peak) / peak:+.4%})")
    log(f"  20b mode 0 stage at m = {M}: {ms:.2f} ms (median of "
        f"{STAGE_REPS[1]}, CUDA events), {int(iters.max())} sweeps")
    keep["mode"] = (d.cpu(), lam.cpu(), iters.cpu())
    del tensor, block, valid, d, lam, iters, flat
    return counts


def _stage_ranks(torch, checks, tmp, keep):
    """20c: both stages over n NCCL ranks (one a card) with real ring
    exchanges, held to 20a and 20b; with four cards or more, the (2, 2)
    LM tests across NCCL ranks."""
    from repro_torch.launch import mesh as tmesh

    n = torch.cuda.device_count()
    if n < 2:
        log(f"  20c did not run: it needs two cards or more (NCCL takes one "
            f"rank a card) and this machine has {n}; the (2, 2) NCCL tests "
            f"{', '.join(t.split('::')[1] for t in RANKS_TESTS)} did not run "
            f"either")
        return
    ref = os.path.join(tmp, "stage_ref.pt")
    out = os.path.join(tmp, "stage_ranks.json")
    torch.save(keep, ref)
    tmesh.spawn(_stage_rank, n, os.path.join(tmp, "store_20c"), ref, out, M,
                join_timeout=900)
    with open(out) as f:
        res = json.load(f)
    for epi in STAGE_EPILOGUES:
        _gate(checks, res[epi] <= STAGE_TOL, f"stage 20c {epi}",
              f"20c {epi} over {n} ranks: d within {res[epi]:.3e} of 20a's "
              f"(of max d); {res[epi + '_ms']:.4f} ms on rank 0 (median)")
    _gate(checks, res["mode_d"] <= STAGE_D_TOL and res["mode_lam"]
          <= STAGE_D_TOL and res["mode_sweeps_equal"], "stage 20c mode",
          f"20c mode stage over {n} ranks: d and λ within "
          f"{res['mode_d']:.3e} / {res['mode_lam']:.3e} of 20b's, sweeps "
          f"equal {res['mode_sweeps_equal']}; {res['mode_ms']:.2f} ms on "
          f"rank 0 (median)")
    if n < 4:
        log(f"  the (2, 2) NCCL tests did not run: {n} cards, they need 4")
        return
    # the tests' ranks take every card, this process's first one too
    torch.cuda.empty_cache()
    # the repository's pytest settings add -q: the last line is the
    # summary ("3 passed in ...")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-rA", "-p",
         "no:cacheprovider", *RANKS_TESTS], cwd=HERE,
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=RANKS_TIMEOUT_S)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    _gate(checks, proc.returncode == 0
          and tail[0].startswith(f"{len(RANKS_TESTS)} passed"),
          "stage 20c NCCL tests",
          f"the (2, 2) NCCL tests on {n} cards: exit {proc.returncode}, "
          f"{tail[0]} ({time.perf_counter() - t0:.1f} s)")
    # what the tests printed (the passes' captured output), or the failure
    out = proc.stdout
    if not proc.returncode and "= PASSES =" in out:
        out = out[out.index("= PASSES ="):]
    log(out[-12000:] + (proc.stderr[-3000:] if proc.returncode else ""))


def _stage_rank(device, ref_path, out_path, m):
    """20c, one rank of n: both epilogues and the mode runner on an (n,)
    mesh, each rank on its rows of 20a's V or its block of the main
    path's tensor (made on every rank from the seed); rank 0 holds the
    joined results to one rank's (20a, 20b) and writes them to
    out_path."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import (MSCConfig, PlantedSpec,
                                  build_epilogue_rowsum, make_planted_tensor)
    from repro_torch.core.msc import mode_slices
    from repro_torch.core.parallel import _flat_schedule
    from repro_torch.core.schedule import build_mode_runner
    from repro_torch.launch.mesh import make_msc_mesh

    def rel(got, want):
        return ((got.cpu() - want).abs().max()
                / want.abs().max().clamp(min=1e-30)).item()

    keep = torch.load(ref_path)
    n, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_msc_mesh("flat", (n,))
    timed = device.type == "cuda"
    res = {"ranks": n}
    v = keep["v"].to(device)
    for epi in STAGE_EPILOGUES:
        stage = build_epilogue_rowsum(mesh, MSCConfig(epilogue=epi,
                                                      use_kernels=True))
        rows = stage.rows(v)
        res[epi] = rel(stage.gather(stage(rows), m), keep[epi])
        res[epi + "_ms"] = _median_ms(torch, lambda: stage(rows),
                                      STAGE_REPS[0]) if timed else 0.0
    cfg = MSCConfig(epsilon=0.5 / (m - m // 10) ** 2, max_extraction_iters=m,
                    use_kernels=True)
    tensor = make_planted_tensor(torch.Generator(device=device)
                                 .manual_seed(SEED), PlantedSpec.paper(m, m))
    sched = _flat_schedule(cfg, mesh)
    block, valid = sched.local_block(mode_slices(tensor, 0))
    del tensor
    run = build_mode_runner(sched)
    d, lam, iters = sched.gather(*run(block, valid))
    want_d, want_lam, want_iters = keep["mode"]
    res["mode_d"] = rel(d[:m], want_d)
    res["mode_lam"] = rel(lam[:m], want_lam)
    res["mode_sweeps_equal"] = int(iters.max()) == int(want_iters.max())
    res["mode_ms"] = _median_ms(torch, lambda: run(block, valid),
                                STAGE_REPS[1]) if timed else 0.0
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)


def _only_phases():
    """`--only 3,11,12,13,14,15,16,17,18,19,20`: the phases to run alone
    (development runs only; with no arguments every phase runs)."""
    if "--only" not in sys.argv:
        return []
    names = sys.argv[sys.argv.index("--only") + 1].split(",")
    bad = [n for n in names
           if n not in ("3", "11", "12", "13", "14", "15", "16", "17", "18",
                        "19", "20")]
    if bad:
        raise SystemExit(f"chip_smoke: --only takes 3, 11, 12, 13, 14, 15, "
                         f"16, 17, 18, 19, 20; got {bad}")
    return names


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
    # phase 17 trains deterministically: cuBLAS reads this when CUDA
    # starts (32 MiB, PyTorch's own size on an H100)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    checks = Checks()
    t_start = time.perf_counter()
    smi = phase_card(torch)
    phase_build()
    only = _only_phases()
    if only:
        # a development run of the named tier phases: no result lines
        tiers = {"3": lambda torch, checks, smi: phase_kernels(torch, checks),
                 "11": phase_cache, "12": phase_scheduler,
                 "13": phase_faults, "14": phase_autotune,
                 "15": phase_multihost, "16": phase_families,
                 "17": phase_training, "18": phase_lm_ranks,
                 "19": phase_dryrun, "20": phase_stages}
        for name in only:
            tiers[name](torch, checks, smi)
        log(f"total {time.perf_counter() - t_start:.1f} s (phases "
            f"{', '.join(only)} only)")
        for f in checks.failures:
            print(f"FAIL {f}", file=sys.stderr)
        return 1 if checks.failures else 3
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
    launches.update(phase_cache(torch, checks, smi))
    launches.update(phase_scheduler(torch, checks, smi))
    launches.update(phase_faults(torch, checks, smi))
    launches.update(phase_autotune(torch, checks, smi))
    launches.update(phase_multihost(torch, checks, smi))
    launches.update(phase_families(torch, checks, smi))
    launches.update(phase_training(torch, checks, smi))
    launches.update(phase_lm_ranks(torch, checks, smi))
    launches.update(phase_dryrun(torch, checks, smi))
    launches.update(phase_stages(torch, checks, smi))
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
            entry["resident"] = rows[(name, "resident")]
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
