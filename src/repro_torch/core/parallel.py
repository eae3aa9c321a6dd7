"""Parallel MSC builders — counterpart of `repro/core/parallel.py`.

Only the flat schedule on one device is ported, for one tensor
(`build_msc_parallel_flat`) and for a bucket of B requests
(`build_msc_batched`): the three modes run one after another through
`ModeSchedule`.  On one device every relayout of the reference
("gspmd", "collective", "collective_stream") is the same local
transpose.  The grouped schedule and meshes of more than one device are
ROADMAP queue 1 item 9; the "auto" relayout and epilogue choosers are
queue 1 item 11.
"""
from __future__ import annotations

import torch

from .msc import MODE_PERMS, mode_slices
from .schedule import MULTI_DEVICE_TODO, ModeSchedule
from .types import MSCConfig, MSCResult, resolve_device

RELAYOUTS = ("gspmd", "collective", "collective_stream")

AUTO_TODO = ("the 'auto' relayout / epilogue choosers are not ported yet: "
             "ROADMAP.md, queue 1 item 11 (roofline)")

# column dim of modes 1/2 is m3, of mode 3 is m2 (see MODE_PERMS)
C_OF = (2, 2, 1)


def batch_perm(mode: int) -> tuple:
    """MODE_PERMS[mode] behind a leading request dim."""
    return (0,) + tuple(a + 1 for a in MODE_PERMS[mode])


def check_relayout(relayout: str, epilogue: str = "allgather") -> None:
    """Raise on a relayout (or epilogue) the one-device port cannot run."""
    if relayout == "auto" or epilogue == "auto":
        raise NotImplementedError(AUTO_TODO)
    if relayout not in RELAYOUTS:
        raise ValueError(f"unknown relayout {relayout!r}; "
                         f"expected one of {RELAYOUTS}")


def build_msc_parallel_flat(cfg: MSCConfig, device="cuda",
                            relayout: str = "gspmd"):
    """tensor → MSCResult on one device, flat schedule."""
    check_relayout(relayout)
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


def build_msc_batched(cfg: MSCConfig, device="cuda",
                      relayout: str = "gspmd"):
    """(batch (B, M1, M2, M3), dims (B, 3)) → MSCResult with a leading B.

    The request-batched flat schedule on one device: B independent MSC
    solves, bucket-padded to one shape with true sizes in `dims`, run
    through one set of batched contractions per mode.  Each request
    gates on its own (per-request `power_iters_run`); every field of the
    ModeResults carries the leading B dim at the padded size, and
    callers slice `[i, :dims[i, j]]` per request (MSCServeEngine does).
    """
    check_relayout(relayout, cfg.epilogue)
    dev = resolve_device(device)
    sched = ModeSchedule(cfg)

    def run(batch, dims) -> MSCResult:
        b = torch.as_tensor(batch).to(dev)
        dims = torch.as_tensor(dims, dtype=torch.int32).to(dev)
        modes = []
        for j in range(3):
            d, lam, iters, valid = sched.run_mode_batched(
                b.permute(batch_perm(j)).contiguous(), dims[:, j],
                dims[:, C_OF[j]])
            modes.append(sched.finalize_mode_batched(d, lam, iters, valid))
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
