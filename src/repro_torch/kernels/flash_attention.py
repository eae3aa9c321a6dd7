"""Online-softmax attention: wrapper of `csrc/flash_attention.cu`.

Counterpart of `repro/kernels/flash_attention.py`.  q (b, sq, d),
k / v (b, skv, d) → (b, sq, d), with `b` batch × heads flattened by the
caller (the GQA expansion stays in `models/layers.py:_attn_pallas`).
Causal masking offset by `q_offset`, a sliding `window` and a tanh
`softcap`; masked scores are -1e30.  Operands are fp32 or bf16 (all
three the same) and contiguous; every score, probability and sum is
fp32, and the output has the input dtype.  The kernel takes d = 32, 64,
128 or 256.

A CUDA tensor launches the kernel on the current stream (or raises); a
CPU tensor runs the plain version in `ref.py`.  `launches` counts kernel
launches that reach the device and nothing else: a call made while a
CUDA graph captures adds to `captured`, and each replay of the graph adds
its captured launches (`serving/graphs.py`).  On the card each call is
one launch of one of three routes, which the kernel picks by sq and dtype (`csrc/
flash_attention.cu`): a small-sq kernel for sq <= `sq_small()` (both
dtypes, the decode cross-attention), a tensor-core tile kernel for bf16
above it, and the CUDA-core tile kernel for fp32 above it.  `route`
forces one of them, for timing the routes against each other.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build, ref

launches = 0
captured = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
ROUTES = {None: 0, "small": 1, "tile": 2}


@functools.cache
def _lib():
    lib = _build.load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.msc_flash_attention.argtypes = [i, i, i, p, p, p, p, i, i, i, f, i,
                                        i, i, i, i, f, i, p]
    lib.msc_flash_attention.restype = i
    lib.msc_flash_sq_small.argtypes = []
    lib.msc_flash_sq_small.restype = i
    lib.msc_flash_attention_error.argtypes = [i]
    lib.msc_flash_attention_error.restype = ctypes.c_char_p
    return lib


def _check(q, k, v) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes fp32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (b, sq, d) and k, v "
                         f"(b, skv, d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on b or d")
    if k.shape[1] < 1:
        raise ValueError("flash_attention needs at least one key")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous tensors")


def sq_small() -> int:
    """The largest sq that takes the small-sq route (the kernel's
    SQ_SMALL; builds the library)."""
    return _lib().msc_flash_sq_small()


def _launch(q, k, v, causal, scale, q_offset, window, softcap, route):
    global launches, captured
    b, sq, d = q.shape
    skv = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes d in {HEAD_DIMS}, "
                         f"got {d}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes 16-byte aligned "
                         "tensors")
    out = torch.empty_like(q)
    lib = _lib()
    dev = q.device
    err = lib.msc_flash_attention(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, sq, skv, scale, int(causal), q_offset,
        int(window is not None), 0 if window is None else window,
        int(softcap is not None), 0.0 if softcap is None else softcap,
        ROUTES[route], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel refused (b={b}, sq={sq}, skv={skv}, "
            f"d={d}, {q.dtype}): {lib.msc_flash_attention_error(err).decode()}")
    if torch.cuda.is_current_stream_capturing():
        captured += 1  # launched by each replay (serving/graphs.py)
    else:
        launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    route: Optional[str] = None) -> torch.Tensor:
    """Fused attention, (b, sq, d) x (b, skv, d) → (b, sq, d).

    `route` ("small" or "tile") forces a kernel route on the card; None
    lets the kernel pick by sq and dtype.  Every route computes the same
    function.
    """
    _check(q, k, v)
    if route not in ROUTES:
        raise ValueError(f"route must be one of {list(ROUTES)}, got {route!r}")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, scale, int(q_offset), window, softcap,
                       route)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                   q_offset=q_offset, window=window,
                                   softcap=softcap)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")
