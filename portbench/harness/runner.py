"""One run of a cell: set-up, the window, the check and the result.

`run_cell` is the whole run but the look for a chip and the printing
(`run.py`), so the tests drive it on the CPU at small sizes.  On a cell
of several chips every rank runs it; rank 0 returns the result, the
others None.  A mix whose driver is "lm_generate" runs as
`harness/lm.py` sets out; the rest of this module is the MSC cells'.

Order of an MSC run: join the mesh (several chips); make the pool on the
device from the seed; build the system and warm up the shapes the
traffic uses (one solve, or two requests through the engine: its two
programs); the window, under the profiler with --trace 1; the memory
peak; with --trace 1 the eigensolve stage timed alone (one-chip solve
cells); the program's state freed; the reference on every pool tensor
that was answered; the comparison.
"""
from __future__ import annotations

import gc
import time
import types

from costs import msc as costs
from harness import cell as cells
from harness import drivers, generate, judge, lm, systems, trace
from harness.report import mark, measured, ranks_entry, result
from reference import msc as reference

ORDER_LEN = 200_000
WARM_REQUESTS = 2  # fast requests through the engine before the window


def _decide(dev):
    """done → rank 0's done, on every rank (one broadcast a solve)."""
    import torch
    import torch.distributed as dist

    def decide(done: bool) -> bool:
        flag = torch.tensor([int(done)], dtype=torch.int32, device=dev)
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    return decide


def _fast(gammas):
    """Pool indices of the warm-up requests: fast ones (the commonest γ)."""
    common = max(set(gammas), key=gammas.count)
    return [i for i, g in enumerate(gammas) if g == common][:WARM_REQUESTS]


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool, *,
             device: str, start_wall: float, rank: int = 0, world: int = 1,
             store=None):
    """The run's result dict on rank 0, None on the other ranks."""
    import torch

    dev = torch.device(device)
    mesh = None
    if world > 1:
        dev, mesh = systems.join_mesh(cell, dev, rank, world, store)
    elif dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    cuda = dev.type == "cuda"
    tr, conf = cell.traffic, cell.config
    if tr["driver"] == "lm_generate":
        return lm.run_cell(cell, seed, seconds, traced, dev, start_wall)
    gammas = generate.gammas(tr, tr["pool"])
    pool = generate.planted_pool(seed, tr, conf["m"], conf["cluster_size"],
                                 dev)
    order = generate.order(seed, tr, ORDER_LEN)
    if cuda:
        torch.cuda.synchronize(dev)
    mark("inputs made", start_wall, rank)
    serving = tr["driver"] == "serve"
    if serving:
        system = systems.engine(cell, dev)
        system.run([pool[i] for i in _fast(gammas)])
    else:
        system = systems.solver(cell, dev, mesh)
        system(pool[int(order[0])])
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.time() - start_wall
    mark("warmed up", start_wall, rank)

    drain = None
    with trace.profiled(traced) as prof:
        if serving:
            window, drain = drivers.serve_window(
                system, pool, order, seconds, tr["clients"], traced)
        else:
            window = drivers.solve_window(
                system, pool, order, seconds, traced,
                None if mesh is None else _decide(dev))
    if drain is not None:
        drain()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    stages = []
    if traced and cuda and not serving and mesh is None:
        stages = systems.mode_stages(cell, pool[0], dev)
    summary = prof.summary
    ranks = [ranks_entry(peak, summary)]
    if mesh is not None:
        import torch.distributed as dist

        ranks = [None] * world
        dist.all_gather_object(ranks, ranks_entry(peak, summary))
        del system, mesh
        systems.leave_mesh()
        if rank != 0:
            return None
    else:
        if serving:
            system.close()
        del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return _judge(cell, pool, window, stages, summary, setup_s, traced,
                  dev, ranks, world)


def _judge(cell, pool, window, stages, summary, setup_s, traced, dev,
           ranks, world) -> dict:
    settings = systems.solver_settings(cell)
    answered = window.answers + window.late
    refs = {idx: reference.solve(pool[idx], settings)
            for idx in sorted({i for i, _ in answered})}
    rows = judge.per_answer(answered, refs, settings)
    correct, checks = judge.verdict(judge.worst(rows, window.missing),
                                    cell.limits)
    failed = window.missing + sum(
        not judge.verdict(r, cell.limits)[0] for r in rows)
    rec = types.SimpleNamespace(
        cell=cell, window=window, stages=stages, trace=summary,
        counters=window.counters, costs=costs,
        k=max(1, min(settings["power_check_every"], settings["power_iters"])),
        matrix_free=settings["matrix_free"],
        solves=[{"shape": (cell.config["m"],) * 3,
                 "sweeps": [a.sweeps for a in modes]}
                for _, modes in window.answers])
    metrics = measured(cell, rec, end_to_end(window, setup_s), traced)
    if not traced:
        # a window that answered nothing has no time to report
        correct = correct and len(metrics) == len(cell.metrics(trace=False))
    return result(correct, window.attempted, failed, metrics, checks, dev,
                  ranks, world, summary, traced)


def end_to_end(window, setup_s: float) -> dict:
    """Every end-to-end metric this window can give."""
    n = len(window.answers)
    out = {"setup_s": setup_s}
    if n:
        out["solve_ms"] = window.seconds / n * 1e3
        out["requests_per_s"] = n / window.seconds
    if window.latencies:
        out["request_p95_ms"] = drivers.p95(window.latencies) * 1e3
    return out
