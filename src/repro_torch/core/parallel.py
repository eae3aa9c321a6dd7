"""Parallel MSC builders — counterpart of `repro/core/parallel.py`.

Only the flat schedule on one device is ported: the three modes run one
after another through `ModeSchedule`.  On one device every relayout of
the reference ("gspmd", "collective", "collective_stream") is the same
local transpose.  The grouped schedule and meshes of more than one
device are ROADMAP queue 1 item 9.
"""
from __future__ import annotations

import torch

from .msc import mode_slices
from .schedule import MULTI_DEVICE_TODO, ModeSchedule
from .types import MSCConfig, MSCResult, resolve_device

RELAYOUTS = ("gspmd", "collective", "collective_stream")


def build_msc_parallel_flat(cfg: MSCConfig, device="cuda",
                            relayout: str = "gspmd"):
    """tensor → MSCResult on one device, flat schedule."""
    if relayout not in RELAYOUTS:
        raise ValueError(f"unknown relayout {relayout!r}; "
                         f"expected one of {RELAYOUTS}")
    dev = resolve_device(device)
    sched = ModeSchedule(cfg)

    def run(tensor) -> MSCResult:
        t = torch.as_tensor(tensor).to(dev)
        modes = []
        for j in range(3):
            d, lam, iters, valid, m = sched.run_mode(mode_slices(t, j))
            modes.append(sched.finalize_mode(d, lam, iters, valid, m))
        return MSCResult(modes=tuple(modes))

    return run


def build_msc_parallel(cfg: MSCConfig, schedule: str = "flat", device="cuda",
                       **kw):
    if schedule == "flat":
        return build_msc_parallel_flat(cfg, device=device, **kw)
    if schedule == "grouped":
        raise NotImplementedError(
            f"schedule 'grouped': {MULTI_DEVICE_TODO}")
    raise ValueError(f"unknown schedule {schedule!r}")
