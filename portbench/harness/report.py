"""What every run reports, whatever its driver: the set-up's progress, the
metrics its readers find, and the result line."""
from __future__ import annotations

import sys
import time

from harness import cell as cells
from harness import trace


def mark(what: str, start_wall: float, rank: int) -> None:
    """The set-up's progress on standard error: seconds since the
    process started."""
    if rank == 0:
        print(f"setup {what} {time.time() - start_wall:.3f} s",
              file=sys.stderr, flush=True)


def ranks_entry(peak, summary) -> dict:
    return {"peak": peak, "busy_s": summary and summary["busy_s"]}


def measured(cell, rec, values: dict, traced: bool) -> dict:
    """With --trace 1 the cell's per-layer metrics that their readers find
    in `rec`; with --trace 0 its end-to-end metrics among `values`."""
    if not traced:
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in cell.metrics(trace=False) if m["name"] in values}
    metrics = {}
    for m in cell.metrics(trace=True):
        value = cells.reader(m["name"], cell.root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def result(correct, attempted, failed, metrics, checks, dev, ranks, world,
           summary, traced) -> dict:
    """The run's result line: the verdict, the counts, the metrics, the
    device, with --trace 1 the breakdown, and the compared numbers."""
    import torch

    cuda = dev.type == "cuda"
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": world,
              "memory_peak_bytes": max(r["peak"] for r in ranks)}
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if traced and summary is not None:
        busy = [r["busy_s"] for r in ranks]
        device["busy_s"] = sum(busy) / len(busy)
        device["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": trace.top(summary["device_ops"]),
                            "idle_gaps": trace.top(summary["idle_gaps"])}
    out["checks"] = checks
    return out
