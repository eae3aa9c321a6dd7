"""Batched slice covariance C_i = T_iᵀT_i: wrapper of `csrc/gram.cu`.

Counterpart of `repro/kernels/gram.py` (the paper's Alg. 1 line 1).
slices (b, r, c) fp32 or bf16, contiguous → (b, c, c); products and sums
are fp32 and the result is written as `out_dtype` (fp32 or bf16; default
the input dtype).  Leading request dims are flattened by `ops.py`.

A CUDA tensor launches the kernel on the current stream (or raises); a
CPU tensor runs the plain version in `ref.py`.  `launches` counts kernel
launches that reach the device and nothing else: a call made while a
CUDA graph captures adds to `captured`, and each replay of the graph adds
its captured launches (`serving/graphs.py`).  The kernel computes one
triangle of each symmetric C and writes both: `tile_plan(c)` gives its
CTAs per slice.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build, ref

launches = 0
captured = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 128  # C tile edge (BM in csrc/gram.cu)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The CTAs of one slice, in launch order (the grid's x axis): the
    (ti, tj) tile pair of each, ti ≤ tj.  An off-diagonal CTA writes the
    tile (ti, tj) of C and its mirror (tj, ti)."""

    tiles: int
    pairs: tuple


def tile_plan(c: int) -> TilePlan:
    """The kernel's tile pairs for c columns (`tile_pair` in csrc/gram.cu):
    row by row over ti ≤ tj, tiles·(tiles + 1)/2 of them."""
    tiles = -(-c // TILE)
    return TilePlan(tiles, tuple((i, j) for i in range(tiles)
                                 for j in range(i, tiles)))


@functools.cache
def _lib():
    lib = _build.load("gram")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msc_gram.argtypes = [i, i, i, p, p, i, i, i, p]
    lib.msc_gram.restype = i
    lib.msc_gram_error.argtypes = [i]
    lib.msc_gram_error.restype = ctypes.c_char_p
    return lib


def _check(slices: torch.Tensor, out_dtype) -> None:
    if slices.dtype not in _DTYPES:
        raise TypeError(f"batched_gram takes fp32 or bf16 slices, got "
                        f"{slices.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"batched_gram writes fp32 or bf16, not {out_dtype}")
    if slices.dim() != 3:
        raise ValueError(f"slices must be (b, r, c), got "
                         f"{tuple(slices.shape)}")
    if slices.shape[-1] < 1:
        raise ValueError("batched_gram needs c >= 1")
    if not slices.is_contiguous():
        raise ValueError("batched_gram kernel takes a contiguous tensor")


def _launch(slices: torch.Tensor, out_dtype) -> torch.Tensor:
    global launches, captured
    b, r, c = slices.shape
    dev = slices.device
    out = torch.empty((b, c, c), dtype=out_dtype, device=dev)
    lib = _lib()
    err = lib.msc_gram(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        _DTYPES[slices.dtype], _DTYPES[out_dtype], slices.data_ptr(),
        out.data_ptr(), b, r, c, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"gram kernel refused (b={b}, r={r}, c={c}, {slices.dtype} -> "
            f"{out_dtype}): {lib.msc_gram_error(err).decode()}")
    if torch.cuda.is_current_stream_capturing():
        captured += 1  # launched by each replay (serving/graphs.py)
    else:
        launches += 1
    return out


def batched_gram(slices: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """(b, r, c) → (b, c, c), accumulated in fp32.  The kernel's tile is
    fixed (128 × 128 of C; 16 rows of T per stage in fp32, 32 in bf16)."""
    out_dtype = out_dtype or slices.dtype
    _check(slices, out_dtype)
    if slices.device.type == "cuda":
        return _launch(slices, out_dtype)
    if slices.device.type == "cpu":
        return ref.batched_gram(slices, out_dtype)
    raise ValueError(f"batched_gram: no kernel for device {slices.device}")
