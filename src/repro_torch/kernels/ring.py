"""Fused |A Bᵀ| row-sum accumulation: wrapper of `csrc/ring.cu`.

Counterpart of `repro/kernels/ring.py`: acc + Σ_j |a bᵀ|_{:,j}, the
compute body of the similarity epilogue (one call with the whole V on
one device).  a (bl, c), b (bc, c), acc (bl,) fp32 or None; the batched
form a (B, bl, c), b (B, bc, c), acc (B, bl) keeps requests apart.
Operands are fp32 or bf16 (both the same) and contiguous; the product
and the sums are fp32.

A CUDA tensor launches the kernel on the current stream (or raises); a
CPU tensor runs the plain version in `ref.py`.  `launches` counts kernel
launches that reach the device and nothing else: a call made while a
CUDA graph captures adds to `captured`, and each replay of the graph adds
its captured launches (`serving/graphs.py`).  The kernel covers (i-tile,
j-tile, request) with 64 x 64 tiles; `tile_plan` gives its grid and the scratch this
wrapper allocates for it (row partials per j-tile and one ticket per
i-tile, see `csrc/ring.cu`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from . import _build, ref

launches = 0
captured = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # rows of a and of b per CTA (BI = BJ in csrc/ring.cu)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The launch of one call: grid (i-tiles, j-tiles, requests), the fp32
    workspace of row partials (B, nj, bl) and the int32 tickets (B,
    i-tiles), zeroed, that find the last CTA of each i-tile."""

    grid: tuple
    nj: int
    workspace: tuple
    tickets: tuple


def tile_plan(batch: int, bl: int, bc: int) -> TilePlan:
    """The kernel's grid and scratch for a (batch, bl, c) x (batch, bc, c)
    call; bc = 0 takes one j-tile of zero rows."""
    ni = -(-bl // TILE)
    nj = max(1, -(-bc // TILE))
    return TilePlan(grid=(ni, nj, batch), nj=nj, workspace=(batch, nj, bl),
                    tickets=(batch, ni))


@functools.cache
def _lib():
    lib = _build.load("ring")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msc_abs_rowsum.argtypes = [i, i, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.msc_abs_rowsum.restype = i
    lib.msc_abs_rowsum_error.argtypes = [i]
    lib.msc_abs_rowsum_error.restype = ctypes.c_char_p
    return lib


def _check(a, b, acc) -> None:
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"abs_rowsum takes two fp32 or two bf16 operands, "
                        f"got {a.dtype} and {b.dtype}")
    if a.dim() not in (2, 3) or b.dim() != a.dim():
        raise ValueError(f"abs_rowsum takes (bl, c) x (bc, c) or "
                         f"(B, bl, c) x (B, bc, c), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.shape[-1] != b.shape[-1] or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"operand shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} disagree")
    if b.device != a.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("abs_rowsum kernel takes contiguous tensors")
    if acc is not None:
        if acc.dtype != torch.float32 or acc.shape != a.shape[:-1]:
            raise ValueError(f"acc must be fp32 {tuple(a.shape[:-1])}, got "
                             f"{acc.dtype} {tuple(acc.shape)}")
        if acc.device != a.device or not acc.is_contiguous():
            raise ValueError("acc must be contiguous and on a's device")


def _launch(a, b, acc):
    global launches, captured
    bl, c = a.shape[-2:]
    bc = b.shape[-2]
    batch = a.shape[0] if a.dim() == 3 else 1
    dev = a.device
    plan = tile_plan(batch, bl, bc)
    out = torch.empty(a.shape[:-1], dtype=torch.float32, device=dev)
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=dev)
    tickets = torch.zeros(plan.tickets, dtype=torch.int32, device=dev)
    lib = _lib()
    err = lib.msc_abs_rowsum(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        _DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
        acc.data_ptr() if acc is not None else None, out.data_ptr(),
        ws.data_ptr(), tickets.data_ptr(), plan.nj, batch, bl, bc, c,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"abs_rowsum kernel refused (B={batch}, bl={bl}, bc={bc}, c={c}, "
            f"{a.dtype}): {lib.msc_abs_rowsum_error(err).decode()}")
    if torch.cuda.is_current_stream_capturing():
        captured += 1  # launched by each replay (serving/graphs.py)
    else:
        launches += 1
    return out


def abs_rowsum(a: torch.Tensor, b: torch.Tensor,
               acc: Optional[torch.Tensor] = None, *,
               block_i: int = 128, block_j: int = 128) -> torch.Tensor:
    """acc + row-sums of |a @ bᵀ| in fp32.

    block_i / block_j are the reference's tile hints; the kernel's tile
    is fixed.
    """
    _check(a, b, acc)
    if a.device.type == "cuda":
        return _launch(a, b, acc)
    if a.device.type == "cpu":
        return ref.abs_rowsum(a, b, acc)
    raise ValueError(f"abs_rowsum: no kernel for device {a.device}")
