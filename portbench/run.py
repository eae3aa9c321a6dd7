"""Run one cell of the benchmark of the PyTorch/CUDA port (`repro_torch`).

    python portbench/run.py --workload msc-m1000.solve --seed 7 \\
        --seconds 10 --trace 0

from the root of a checkout.  Makes the cell's inputs on the card from
the seed, warms up, measures for --seconds, checks every answer against
the plain reference and prints one JSON line last: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or
with --trace 1 its per-layer ones), `device`, with --trace 1
`breakdown`, and `checks` (each compared number with its limit), which
the last lines of standard error repeat.

Exits with 2 and prints no result without enough CUDA cards, and with 3
if `jax`, `jaxlib`, `flax` or the JAX package `repro` (compared by whole
top-level module name) is loaded once the window has closed.  A cell on
several chips runs one process a card: this one is rank 0 and starts
the others (`--rank`, `--store`, internal), which join through a
FileStore under TMPDIR.  The kernels build once into the checkout's
`src/repro_torch/kernels/build/`.
"""
from __future__ import annotations

import time

START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, os.path.join(ROOT, "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WORKER_WAIT_S = 120


def process_start() -> float:
    """Wall time at which this process started (/proc/self/stat)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return START - max(0.0, age - (time.time() - START))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run must not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def workers(argv, chips: int, store: str) -> list:
    """Ranks 1…chips−1 of a cell on several cards, started now."""
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *argv, "--rank", str(r),
         "--store", store], stdout=subprocess.DEVNULL)
        for r in range(1, chips)]


def report(result: dict) -> None:
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    start = process_start()
    import torch

    from harness import cell as cells
    from harness.report import mark
    from harness.runner import run_cell

    mark("torch imported", start, args.rank)
    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    mark("CUDA found", start, args.rank)
    kw = dict(device="cuda", start_wall=start, world=cell.chips)
    if args.rank:
        run_cell(cell, args.seed, args.seconds, bool(args.trace),
                 rank=args.rank, store=args.store, **kw)
        return 0
    tmp = procs = None
    try:
        if cell.chips > 1:
            tmp = tempfile.mkdtemp(prefix="portbench_store_")
            kw["store"] = os.path.join(tmp, "store")
            procs = workers(argv, cell.chips, kw["store"])
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          **kw)
        for p in procs or ():
            if p.wait(timeout=WORKER_WAIT_S) != 0:
                print(f"rank {procs.index(p) + 1} exited {p.returncode}",
                      file=sys.stderr)
                return 1
    finally:
        for p in procs or ():
            if p.poll() is None:
                p.kill()
                p.wait()
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    loaded = forbidden_modules()
    if loaded:
        print(f"loaded after the window: {loaded}", file=sys.stderr)
        return 3
    report(result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
