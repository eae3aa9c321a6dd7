"""Fused matrix-free power iteration: wrapper of `csrc/power_iter.cu`.

Counterpart of `repro/kernels/power_iter.py`.  Three entry points share
one CUDA source with two routes, one CTA per slice and one launch per
call either way (see `csrc/power_iter.cu`):

* streaming, where rows are a multiple of 16 bytes and c ≤ MAX_COLS:
  WARPS warps each take every WARPS-th row; a lane holds round(v) and its
  warp's partial w for the same 16-byte chunks of every row in
  registers, so each element of T is loaded once per sweep and used
  twice.  Rows reach registers straight from device memory ("direct",
  c·elt ≤ DIRECT_BYTES) or through a shared-memory ring ("ring"); STREAM
  names the one `route()` picks for each dtype.
* "general": v and w in shared memory, each row tile of T staged there
  once per sweep; every other c.

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
its captured launches (`serving/graphs.py`).  `route=` forces a route,
for timing.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

launches = 0
captured = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"general": 0, "direct": 1, "ring": 2}
WARPS = 4            # warps per CTA on the streaming route; warp q takes
#                      rows k ≡ q (mod 4) and the partials add in warp order
MAX_COLS = 2048      # v and w of c/32 fp32 each per lane fit in registers
DIRECT_BYTES = 4096  # "direct": two rows of c·elt bytes per warp in registers
# the streaming variant `route` picks per dtype: the faster at 1000³ on an
# H100 (chip_smoke.py times every route; PERF.md)
STREAM = {torch.float32: "direct", torch.bfloat16: "ring"}


def routes(c: int, dtype) -> tuple:
    """Every route the kernel takes for rows of c elements of `dtype`."""
    elt = torch.empty((), dtype=dtype).element_size()
    if (c * elt) % 16 or c > MAX_COLS:
        return ("general",)
    return ("general", "ring") + (("direct",) if c * elt <= DIRECT_BYTES
                                  else ())


def route(c: int, dtype) -> str:
    """The route a call with rows of c elements of `dtype` takes:
    STREAM[dtype] where the kernel can stream (falling back to "ring"
    where "direct" cannot hold two rows), else "general"."""
    ok = routes(c, dtype)
    if len(ok) == 1:
        return "general"
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
    lib.msc_power_iter_error.argtypes = [i]
    lib.msc_power_iter_error.restype = ctypes.c_char_p
    return lib


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
        pick = route(c, slices.dtype) if aligned else "general"
    elif force not in routes(c, slices.dtype) or (force != "general"
                                                  and not aligned):
        raise ValueError(f"power_iter: no {force!r} route for c={c} "
                         f"{slices.dtype} (takes {routes(c, slices.dtype)}, "
                         "the streaming ones at a 16-byte aligned base)")
    else:
        pick = force
    b = v0.numel() // c if c else 0
    dev = slices.device
    v_out = torch.empty(lead + (c,), dtype=torch.float32, device=dev)
    lam = torch.empty(lead, dtype=torch.float32, device=dev)
    resid = torch.empty(lead, dtype=torch.float32, device=dev)
    w = None if normalize else torch.empty_like(v_out)
    lib = _lib()
    err = lib.msc_power_iter(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        _DTYPES[slices.dtype], _ROUTES[pick], slices.data_ptr(),
        v0.data_ptr(), v_out.data_ptr(), lam.data_ptr(), resid.data_ptr(),
        w.data_ptr() if w is not None else None, b, r, c, n_upd,
        int(lambda_pass), int(emit_gate), int(normalize),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"power_iter kernel refused (b={b}, r={r}, c={c}, "
            f"{slices.dtype}, route {pick}): "
            f"{lib.msc_power_iter_error(err).decode()}; "
            "v and w (2·c fp32) and one row of T must fit in 227 KB of "
            "shared memory")
    if torch.cuda.is_current_stream_capturing():
        captured += 1  # launched by each replay (serving/graphs.py)
    else:
        launches += 1
    return lam, v_out, resid, w


def _dispatch(slices, v, n_upd, route=None, **flags):
    _check(slices, v)
    if route is not None and route not in _ROUTES:
        raise ValueError(f"power_iter: route must be one of "
                         f"{tuple(_ROUTES)} or None, got {route!r}")
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
