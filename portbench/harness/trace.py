"""What the profiler saw in a traced window.

The window runs under `torch.profiler` (CPU and CUDA activities) inside a
`record_function("portbench.window")` span; the trace is written to the
run's TMPDIR, read back and deleted.  From it:

  busy_s      the union of the device's kernel, memcpy and memset
              intervals inside the window span
  window_s    the window span's length
  device_ops  device seconds by operation name
  nccl_s      device seconds in NCCL's own kernels (names with "nccl")
  idle_gaps   the device's idle time inside the window, by what the host
              was doing: the innermost host event (an operator, a CUDA
              runtime call or one of the harness's spans) over each gap's
              middle

The harness's spans name its calls into the program's layers
(`span`), so a gap while the host is in one of them is named after it.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@contextlib.contextmanager
def span(name: str, on: bool):
    """A named host span in the trace (nothing when tracing is off)."""
    if not on:
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profiled(on: bool):
    """Profile the body when `on`; yields a holder whose `summary` is
    filled once the body has ended (None when off)."""
    holder = type("Traced", (), {"summary": None})()
    if not on:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            yield holder
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    holder.summary = summarize(events)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list) -> dict:
    """The window's device busy time, its length, device seconds by name,
    NCCL seconds and idle seconds by host activity (all in seconds)."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("no window span in the trace")
    ws = float(win[0]["ts"])
    we = ws + float(win[0]["dur"])
    device, ops, nccl = [], defaultdict(float), 0.0
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            s, t = max(s, ws), min(t, we)
            if t <= s:
                continue
            device.append((s, t))
            ops[e["name"]] += (t - s) / 1e6
            if "nccl" in e["name"].lower():
                nccl += (t - s) / 1e6
        elif cat in HOST_CATS and e.get("name") != WINDOW:
            host.append((s, t, e["name"]))
    busy = _merge(device)
    host.sort()
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edges = [ws] + [x for iv in busy for x in iv] + [we]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[_host_at(host, starts, (a + b) / 2)] += (b - a) / 1e6
    return {"busy_s": sum(e - s for s, e in busy) / 1e6,
            "window_s": (we - ws) / 1e6, "device_ops": dict(ops),
            "nccl_s": nccl, "idle_gaps": dict(gaps)}


def _host_at(host, starts, t, look=5000) -> str:
    """Name of the innermost host event over time t (the latest-starting
    one that still runs at t), or "host: between calls"."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - look), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host: between calls"


def top(d: dict, n: int = 10) -> list:
    """The n largest entries of {name: seconds} as [[name, seconds]]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
