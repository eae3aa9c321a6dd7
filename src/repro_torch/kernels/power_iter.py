"""Fused matrix-free power iteration: wrapper of `csrc/power_iter.cu`.

Counterpart of `repro/kernels/power_iter.py`.  Three entry points share
one CUDA source with three routes, one launch per call whichever runs
(see `csrc/power_iter.cu`):

* streaming, where rows are a multiple of 16 bytes and c ≤ MAX_COLS:
  one CTA per slice; WARPS warps each take every WARPS-th row; a lane
  holds round(v) and its warp's partial w for the same 16-byte chunks of
  every row in registers, so each element of T is loaded once per sweep
  and used twice.  Rows reach registers straight from device memory
  ("direct", c·elt ≤ DIRECT_BYTES) or through a shared-memory ring
  ("ring"); STREAM names the one `route()` picks for each dtype.
* "resident", on the same rows, for a launch that passes over T k ≥ 2
  times (a gate chunk's sweeps, or sweeps and the λ pass): one
  thread-block cluster of G CTAs per slice (`resident_plan`: the
  smallest power of two G ≤ 16 whose bands fit the CTAs' shared memory),
  each CTA holding its band of rows in shared memory from the first pass
  on, so T is read from device memory once per launch; rows beyond what
  shared memory holds are read again each pass, from L2.  The clusters
  are persistent, each walking over its share of the slices.
* "general": v and w in shared memory, each row tile of T staged there
  once per sweep; every other c.

`route(c, dtype, k, r)` picks "resident" where RESIDENT[dtype] holds:
at least its passes over T and at least its share of the rows held in
shared memory (an H100 measured it faster there, PERF.md; bf16 streams
everywhere); else STREAM[dtype] where the kernel can stream (falling
back to "ring" where "direct" cannot hold two rows); else "general".
The rows r and the passes k are what the call gives; `power_matvec` (one
pass) always streams.

* power_iterate       — n_iters sweeps + a trailing λ = ‖T v‖² pass.
* power_iterate_chunk — k sweeps; also λ = vᵀw and ‖w − λv‖ from the
  last sweep before normalizing (the convergence-gate probe).
* power_matvec        — one unnormalized sweep, the raw fp32 w = Tᵀ(T v).

Slices (..., b, r, c) are fp32 or bf16 and contiguous; v is fp32
(..., b, c).  Leading request dims flatten into the slice grid.  A CUDA
tensor launches the kernel on the current stream (or raises); a CPU
tensor runs the plain version in `ref.py`.  `launches` counts kernel
launches that reach the device and nothing else: a call made while a
CUDA graph captures adds to `captured`, and each replay of the graph adds
its captured launches (`serving/graphs.py`).  A launch on the resident
route also counts `kernels.power_resident` (`repro_torch.spans`, while
tracing), eager or under capture alike.  `route=` forces a route, for
timing.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch import spans

from . import _build, ref

launches = 0
captured = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"general": 0, "direct": 1, "ring": 2, "resident": 3}
WARPS = 4            # warps per CTA on the streaming route; warp q takes
#                      rows k ≡ q (mod 4) and the partials add in warp order
MAX_COLS = 2048      # v and w of c/32 fp32 each per lane fit in registers
DIRECT_BYTES = 4096  # "direct": two rows of c·elt bytes per warp in registers
# the streaming variant `route` picks per dtype: the faster at 1000³ on an
# H100 (chip_smoke.py times every route; PERF.md)
STREAM = {torch.float32: "direct", torch.bfloat16: "ring"}
RESIDENT_WARPS = 8     # warps per CTA on the resident route
SMEM_BYTES = 232448    # shared memory one CTA may hold on an H100
COPY_BYTES = 16384     # a bulk copy brings whole rows, at most this many bytes
#                        (one row where a row is larger)
CLUSTER_MAX = 16       # CTAs in a cluster where the card allows beyond 8
# where `route` takes the resident route, by dtype: (fewest passes over T
# in one launch, least share of a slice's rows in the cluster's shared
# memory), or None where streaming was the faster at every shape measured
# (chip_smoke.py times both sides on an H100; PERF.md)
RESIDENT = {torch.float32: (6, 0.75), torch.bfloat16: None}


@dataclasses.dataclass(frozen=True)
class ResidentPlan:
    """One slice's cluster on the resident route: `g` CTAs, CTA i on rows
    [i·band, (i + 1)·band), the first `rows` of its band held in shared
    memory, one bulk copy (and barrier) per `per_bar` rows."""

    g: int
    band: int
    rows: int
    per_bar: int

    def share(self, r: int) -> float:
        """The share of a slice's r rows held in shared memory."""
        return min(r, self.g * self.rows) / r


def _elt(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def resident_smem(c: int, dtype, rows: int, per_bar: int) -> int:
    """Shared memory of one resident CTA holding `rows` rows
    (`csrc/power_iter.cu` resident_smem): the barriers, v, the partial
    and whole w and their scratch (5 c + 128 floats), the warp sums and
    slots, the rows, and the zeroed bytes that the last row's chunks read
    past it."""
    bars = -(-rows // per_bar)
    head = 5 * c + 128 + RESIDENT_WARPS + 16 + 4
    return ((bars * 8 + 15) // 16 * 16 + 4 * head + rows * c * _elt(dtype)
            + _tail(c, dtype))


def _tail(c: int, dtype) -> int:
    nq = c * _elt(dtype) // 16
    nch = 1
    while 32 * nch < nq:
        nch *= 2
    return (32 * nch - nq) * 16


def resident_plan(r: int, c: int, dtype,
                  g_max: int = CLUSTER_MAX) -> Optional[ResidentPlan]:
    """The cluster of a slice of r rows of c elements: the smallest power
    of two G ≤ g_max whose bands fit the CTAs' shared memory, else g_max,
    with as many rows of each band in shared memory as fit.  None where
    not one row fits."""
    if r < 1:
        return None
    row = c * _elt(dtype)
    per_bar = max(1, COPY_BYTES // row)
    fit = max(0, (SMEM_BYTES - resident_smem(c, dtype, 0, 1)) // row)
    while fit > 0 and resident_smem(c, dtype, fit, per_bar) > SMEM_BYTES:
        fit -= 1
    if fit < 1:
        return None
    g = 1
    while g < g_max and -(-r // g) > fit:
        g *= 2
    band = -(-r // g)
    return ResidentPlan(g, band, min(band, fit), per_bar)


def routes(c: int, dtype, k: int = 1) -> tuple:
    """Every route the kernel takes for rows of c elements of `dtype` in a
    launch that passes over T k times."""
    elt = _elt(dtype)
    if (c * elt) % 16 or c > MAX_COLS:
        return ("general",)
    return (("general", "ring")
            + (("direct",) if c * elt <= DIRECT_BYTES else ())
            + (("resident",) if k >= 2 else ()))


def route(c: int, dtype, k: int = 1, r: Optional[int] = None) -> str:
    """The route a launch over slices of r rows of c elements of `dtype`
    that passes over T k times takes: "resident" where RESIDENT[dtype]
    holds (k passes or more, and the cluster holds that share of the rows
    in shared memory), else STREAM[dtype] where the kernel can stream
    (falling back to "ring" where "direct" cannot hold two rows), else
    "general"."""
    ok = routes(c, dtype, k)
    if len(ok) == 1:
        return "general"
    rule = RESIDENT[dtype]
    if rule is not None and "resident" in ok and r and k >= rule[0]:
        plan = resident_plan(r, c, dtype)
        if plan is not None and plan.share(r) >= rule[1]:
            return "resident"
    return STREAM[dtype] if STREAM[dtype] in ok else "ring"


@functools.cache
def _lib():
    lib = _build.load("power_iter")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msc_power_iter.argtypes = [i, i, i, p, p, p, p, p, p, i, i, i, i, i,
                                   i, i, p]
    lib.msc_power_iter.restype = i
    lib.msc_power_iter_ctas_per_sm.argtypes = [i, i, i, i,
                                               ctypes.POINTER(i)]
    lib.msc_power_iter_ctas_per_sm.restype = i
    lib.msc_power_iter_resident.argtypes = [i, i, p, p, p, p, p, i, i, i,
                                            i, i, i, i, i, i, i, p]
    lib.msc_power_iter_resident.restype = i
    lib.msc_power_iter_resident_clusters.argtypes = [i, i, i, i, i, i, i, i,
                                                     ctypes.POINTER(i)]
    lib.msc_power_iter_resident_clusters.restype = i
    lib.msc_power_iter_cluster_max.argtypes = [i, ctypes.POINTER(i)]
    lib.msc_power_iter_cluster_max.restype = i
    lib.msc_power_iter_error.argtypes = [i]
    lib.msc_power_iter_error.restype = ctypes.c_char_p
    return lib


@functools.cache
def cluster_max(device: int) -> int:
    """The largest cluster the card takes for the resident kernel: 16
    where it allows clusters beyond the portable 8, else 8."""
    n = ctypes.c_int(0)
    lib = _lib()
    err = lib.msc_power_iter_cluster_max(device, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"power_iter: {lib.msc_power_iter_error(err)}")
    return n.value


def card_plan(r: int, c: int, dtype, device=None) -> ResidentPlan:
    """`resident_plan` with the current card's largest cluster; raises
    where there is none."""
    plan = resident_plan(r, c, dtype, cluster_max(
        torch.cuda.current_device() if device is None else device))
    if plan is None:
        raise ValueError(f"power_iter: no resident plan for r={r}, c={c} "
                         f"{dtype} (not one row fits a CTA)")
    return plan


def resident_clusters(r: int, c: int, dtype, device=None) -> int:
    """Clusters of the resident route resident on the card at once for
    slices of r rows of c elements of `dtype`: a launch of b slices runs
    min(b, this) clusters, each walking over its share of the slices."""
    dev = torch.cuda.current_device() if device is None else device
    plan = card_plan(r, c, dtype, dev)
    n = ctypes.c_int(0)
    lib = _lib()
    err = lib.msc_power_iter_resident_clusters(
        dev, _DTYPES[dtype], r, c, plan.g, plan.band, plan.rows,
        plan.per_bar, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"power_iter: no resident clusters for r={r}, "
                           f"c={c} {dtype}: "
                           f"{lib.msc_power_iter_error(err).decode()}")
    return n.value


def ctas_per_sm(c: int, dtype, route_name: str, device=None) -> int:
    """CTAs of a streaming route ("direct" or "ring") resident on one SM
    of the current card for rows of c elements of `dtype`: one launch of
    b slices takes b / (this × SMs) waves."""
    n = ctypes.c_int(0)
    lib = _lib()
    err = lib.msc_power_iter_ctas_per_sm(
        torch.cuda.current_device() if device is None else device,
        _DTYPES[dtype], _ROUTES[route_name], c, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"power_iter: no {route_name!r} route for c={c} "
                           f"{dtype}: {lib.msc_power_iter_error(err).decode()}")
    return n.value


def _check(slices: torch.Tensor, v: torch.Tensor) -> None:
    if slices.dtype not in _DTYPES:
        raise TypeError(f"power_iter kernel takes fp32 or bf16 slices, "
                        f"got {slices.dtype}")
    if slices.dim() < 3:
        raise ValueError(f"slices must be (..., b, r, c), got "
                         f"{tuple(slices.shape)}")
    if v.dtype != torch.float32:
        raise TypeError(f"v must be fp32, got {v.dtype}")
    if tuple(v.shape) != tuple(slices.shape[:-2]) + (slices.shape[-1],):
        raise ValueError(f"v {tuple(v.shape)} does not match slices "
                         f"{tuple(slices.shape)}")
    if v.device != slices.device:
        raise ValueError(f"slices on {slices.device}, v on {v.device}")
    if not (slices.is_contiguous() and v.is_contiguous()):
        raise ValueError("power_iter kernel takes contiguous tensors")


def _launch(slices, v0, n_upd, *, lambda_pass, emit_gate, normalize=True,
            force=None):
    """(lam, v, resid, w) from the CUDA kernel; w is None unless
    normalize is False."""
    global launches, captured
    lead = slices.shape[:-2]
    r, c = slices.shape[-2:]
    aligned = slices.data_ptr() % 16 == 0
    if force is None:
        pick = (route(c, slices.dtype, n_upd + int(lambda_pass), r)
                if aligned else "general")
    elif force != "general" and not aligned:
        raise ValueError(f"power_iter: the {force!r} route takes a 16-byte "
                         "aligned base")
    else:
        pick = force
    b = v0.numel() // c if c else 0
    dev = slices.device
    v_out = torch.empty(lead + (c,), dtype=torch.float32, device=dev)
    lam = torch.empty(lead, dtype=torch.float32, device=dev)
    resid = torch.empty(lead, dtype=torch.float32, device=dev)
    w = None if normalize else torch.empty_like(v_out)
    lib = _lib()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if pick == "resident":
        plan = card_plan(r, c, slices.dtype, index)
        err = lib.msc_power_iter_resident(
            index, _DTYPES[slices.dtype], slices.data_ptr(), v0.data_ptr(),
            v_out.data_ptr(), lam.data_ptr(), resid.data_ptr(), b, r, c,
            plan.g, plan.band, plan.rows, plan.per_bar, n_upd,
            int(lambda_pass), int(emit_gate), stream)
    else:
        err = lib.msc_power_iter(
            index, _DTYPES[slices.dtype], _ROUTES[pick], slices.data_ptr(),
            v0.data_ptr(), v_out.data_ptr(), lam.data_ptr(),
            resid.data_ptr(), w.data_ptr() if w is not None else None, b, r,
            c, n_upd, int(lambda_pass), int(emit_gate), int(normalize),
            stream)
    if err != 0:
        raise RuntimeError(
            f"power_iter kernel refused (b={b}, r={r}, c={c}, "
            f"{slices.dtype}, route {pick}): "
            f"{lib.msc_power_iter_error(err).decode()}; "
            "v and w (2·c fp32) and one row of T must fit in 227 KB of "
            "shared memory (the resident route: its plan's clusters "
            "resident on the card)")
    if torch.cuda.is_current_stream_capturing():
        captured += 1  # launched by each replay (serving/graphs.py)
    else:
        launches += 1
    if pick == "resident":
        spans.count("kernels.power_resident")
    return lam, v_out, resid, w


def _dispatch(slices, v, n_upd, route=None, **flags):
    _check(slices, v)
    if route is not None and route not in _ROUTES:
        raise ValueError(f"power_iter: route must be one of "
                         f"{tuple(_ROUTES)} or None, got {route!r}")
    passes = n_upd + int(flags["lambda_pass"])
    ok = routes(slices.shape[-1], slices.dtype, passes)
    if route is not None and route not in ok:
        raise ValueError(f"power_iter: no {route!r} route for c="
                         f"{slices.shape[-1]} {slices.dtype} and {passes} "
                         f"passes over T (takes {ok})")
    if slices.device.type == "cuda":
        return _launch(slices, v, n_upd, force=route, **flags)
    if slices.device.type == "cpu":
        return ref.power_sweeps(slices, v, n_upd, **flags)
    raise ValueError(f"power_iter: no kernel for device {slices.device}")


def power_iterate(slices: torch.Tensor, v0: torch.Tensor, n_iters: int, *,
                  block_r: int = 256, route=None):
    """n_iters fused sweeps + λ pass.  Returns (lam (..., b), v (..., b, c)).

    block_r is the reference's tile hint; the kernel sizes its own tiles.
    """
    lam, v, _, _ = _dispatch(slices, v0, n_iters, route, lambda_pass=True,
                             emit_gate=False)
    return lam, v


def power_iterate_chunk(slices: torch.Tensor, v: torch.Tensor, k: int, *,
                        block_r: int = 256, route=None):
    """k fused sweeps from v with the gate probe.  Returns (v_new, lam, resid)."""
    lam, v_new, resid, _ = _dispatch(slices, v, k, route, lambda_pass=False,
                                     emit_gate=True)
    return v_new, lam, resid


def power_matvec(slices: torch.Tensor, v: torch.Tensor, *,
                 block_r: int = 256, route=None) -> torch.Tensor:
    """One unnormalized sweep: w = Tᵀ(T v), fp32 (..., b, c)."""
    _, _, _, w = _dispatch(slices, v, 1, route, lambda_pass=False,
                           emit_gate=False, normalize=False)
    return w
