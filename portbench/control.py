"""Readings that set a cell's limits: the controls, and the program's own.

    python portbench/control.py --workload msc-m1000.solve \\
        --seeds 11,12,13 [--program SECONDS] [--out FILE]

MSC cells: for each seed, the cell's pool is made as a run makes it.
The control is the reference put in the program's place and computed
one precision below the configuration's fp32: every product's operands
rounded to TF32, sums in fp32 (`reference.msc.tf32`).  It answers every
pool tensor once, and its answers are compared with the fp32
reference's by the run's own comparison (`harness/judge.py`); a sound
limit lies below the control's numbers.  With --program, each seed also
drives a whole run of the cell (a window of SECONDS) in this process,
whose numbers are the program's readings.

LM cells (the mix's driver "lm_generate"): for each seed the program's
window of SECONDS (10 by default), judged as a run judges it, and the
two controls of `harness/lm.py:readings`.

One JSON line a seed and side, on standard output and appended to
--out.  One-chip cells; the benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]


def control_numbers(cell, seed: int, device) -> dict:
    """The control's compared numbers on one seed's pool."""
    import torch

    from harness import generate, judge, systems
    from reference import msc as reference

    conf, tr = cell.config, cell.traffic
    pool = generate.planted_pool(seed, tr, conf["m"], conf["cluster_size"],
                                 device)
    settings = systems.solver_settings(cell)
    refs, got = {}, []
    for i in range(tr["pool"]):
        refs[i] = reference.solve(pool[i], settings)
        got.append((i, reference.solve(pool[i], settings,
                                       operand=reference.tf32)))
    del pool
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return judge.worst(judge.per_answer(got, refs, settings))


def msc_lines(cell, seed: int, args) -> list:
    """The program's readings (with --program) and the control's on one
    seed of an MSC cell."""
    from harness.runner import run_cell

    lines = []
    if args.program > 0:
        t = time.time()
        res = run_cell(cell, seed, args.program, False, device=args.device,
                       start_wall=t)
        lines.append({"side": "program", "seed": seed,
                      "correct": res["correct"],
                      "attempted": res["attempted"],
                      "numbers": {k: c["value"] for k, c in
                                  res["checks"].items()}})
    t = time.perf_counter()
    nums = control_numbers(cell, seed, args.device)
    lines.append({"side": "control", "seed": seed, "numbers": nums,
                  "seconds": time.perf_counter() - t})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from harness import cell as cells

    cell = cells.load(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell.traffic["driver"] == "lm_generate":
            from harness import lm

            lines = lm.readings(cell, seed, args.program or 10.0,
                                args.device)
        else:
            lines = msc_lines(cell, seed, args)
        for line in lines:
            line["workload"] = cell.name
            text = json.dumps(line)
            print(text, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(text + "\n")
    return 0




if __name__ == "__main__":
    raise SystemExit(main())
