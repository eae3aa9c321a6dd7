"""Fused matrix-free power iteration: wrapper of `csrc/power_iter.cu`.

Counterpart of `repro/kernels/power_iter.py`.  Three entry points share
one CUDA kernel (one CTA per slice, v and w in shared memory, each row
tile of T staged once per sweep):

* power_iterate       — n_iters sweeps + a trailing λ = ‖T v‖² pass.
* power_iterate_chunk — k sweeps; also λ = vᵀw and ‖w − λv‖ from the
  last sweep before normalizing (the convergence-gate probe).
* power_matvec        — one unnormalized sweep, the raw fp32 w = Tᵀ(T v).

Slices (..., b, r, c) are fp32 or bf16 and contiguous; v is fp32
(..., b, c).  Leading request dims flatten into the slice grid.  A CUDA
tensor launches the kernel on the current stream (or raises); a CPU
tensor runs the plain version in `ref.py`.  `launches` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    lib = _build.load("power_iter")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msc_power_iter.argtypes = [i, i, p, p, p, p, p, p, i, i, i, i, i, i,
                                   i, p]
    lib.msc_power_iter.restype = i
    lib.msc_power_iter_error.argtypes = [i]
    lib.msc_power_iter_error.restype = ctypes.c_char_p
    return lib


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


def _launch(slices, v0, n_upd, *, lambda_pass, emit_gate, normalize=True):
    """(lam, v, resid, w) from the CUDA kernel; w is None unless
    normalize is False."""
    global launches
    lead = slices.shape[:-2]
    r, c = slices.shape[-2:]
    b = v0.numel() // c if c else 0
    dev = slices.device
    v_out = torch.empty(lead + (c,), dtype=torch.float32, device=dev)
    lam = torch.empty(lead, dtype=torch.float32, device=dev)
    resid = torch.empty(lead, dtype=torch.float32, device=dev)
    w = None if normalize else torch.empty_like(v_out)
    lib = _lib()
    err = lib.msc_power_iter(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        _DTYPES[slices.dtype], slices.data_ptr(), v0.data_ptr(),
        v_out.data_ptr(), lam.data_ptr(), resid.data_ptr(),
        w.data_ptr() if w is not None else None, b, r, c, n_upd,
        int(lambda_pass), int(emit_gate), int(normalize),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"power_iter kernel refused (b={b}, r={r}, c={c}, "
            f"{slices.dtype}): {lib.msc_power_iter_error(err).decode()}; "
            "v and w (2·c fp32) and one row of T must fit in 227 KB of "
            "shared memory")
    launches += 1
    return lam, v_out, resid, w


def _dispatch(slices, v, n_upd, **flags):
    _check(slices, v)
    if slices.device.type == "cuda":
        return _launch(slices, v, n_upd, **flags)
    if slices.device.type == "cpu":
        return ref.power_sweeps(slices, v, n_upd, **flags)
    raise ValueError(f"power_iter: no kernel for device {slices.device}")


def power_iterate(slices: torch.Tensor, v0: torch.Tensor, n_iters: int, *,
                  block_r: int = 256):
    """n_iters fused sweeps + λ pass.  Returns (lam (..., b), v (..., b, c)).

    block_r is the reference's tile hint; the kernel sizes its own tiles.
    """
    lam, v, _, _ = _dispatch(slices, v0, n_iters, lambda_pass=True,
                             emit_gate=False)
    return lam, v


def power_iterate_chunk(slices: torch.Tensor, v: torch.Tensor, k: int, *,
                        block_r: int = 256):
    """k fused sweeps from v with the gate probe.  Returns (v_new, lam, resid)."""
    lam, v_new, resid, _ = _dispatch(slices, v, k, lambda_pass=False,
                                     emit_gate=True)
    return v_new, lam, resid


def power_matvec(slices: torch.Tensor, v: torch.Tensor, *,
                 block_r: int = 256) -> torch.Tensor:
    """One unnormalized sweep: w = Tᵀ(T v), fp32 (..., b, c)."""
    _, _, _, w = _dispatch(slices, v, 1, lambda_pass=False, emit_gate=False,
                           normalize=False)
    return w
