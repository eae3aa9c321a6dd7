"""The least time of MSC's work on one NVIDIA H100, from shapes and sweeps.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense:
3.35 TB/s of HBM, 67 TFLOP/s fp32 outside the tensor cores, 989 TFLOP/s
bf16.  The runs record the card's power limit beside every share.

Each piece of work is bounded by the larger of its bytes over the
bandwidth and its operations over the peak, counting each input byte
read once and each output written once (the repository's kernel-table
rule), and the pieces' bounds add up:

  power chunk     k sweeps of w = Tᵀ(T v) over b slices (r, c): T read
                  once a gate chunk, v and the outputs once;
                  4·b·r·c·k flops
  gram formation  C_i = T_iᵀT_i: T read, C written; b·r·c(c+1) flops
                  (one triangle's multiply-adds)
  gram chunk      k sweeps of w = C v: C read once a gate chunk;
                  2·b·c²·k flops
  epilogue        d = rowsum |V Vᵀ| of V (m, c): V read twice, d
                  written; 2·m²·c flops

The work a solve needs depends on the sweeps its gate ran, never on the
kernels that ran it, so a share reads the same work whatever a later
change fuses or removes.
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
MODE_PERMS = ((0, 1, 2), (1, 0, 2), (2, 0, 1))


def bound_s(n_bytes: float, flops: float, dtype: str = "float32") -> float:
    """Least seconds of one piece of work at the card's peaks."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def power_chunk(b: int, r: int, c: int, k: int, elt: int = 4):
    """(bytes, flops) of one gate chunk of the matrix-free eigensolve."""
    return b * r * c * elt + 2 * b * c * 4 + 2 * b * 4, 4 * b * r * c * k


def batched_gram(b: int, r: int, c: int, elt: int = 4):
    """(bytes, flops) of forming every slice's C = TᵀT in fp32."""
    return b * r * c * elt + b * c * c * 4, b * r * c * (c + 1)


def gram_chunk(b: int, c: int, k: int):
    """(bytes, flops) of one gate chunk of power iteration on C."""
    return b * c * c * 4 + 2 * b * c * 4 + 2 * b * 4, 2 * b * c * c * k


def abs_rowsum(m: int, c: int, elt: int = 4):
    """(bytes, flops) of d = rowsum |V Vᵀ| for V (m, c)."""
    return 2 * m * c * elt + m * 4, 2 * m * m * c


def mode_s(shape, sweeps: int, k: int, matrix_free: bool) -> float:
    """Least seconds of one mode's eigensolve and epilogue: the mode's
    slices (m, r, c) of `shape` (m1, m2, m3), its sweeps in chunks of k."""
    b, r, c = shape
    chunks = math.ceil(sweeps / k)
    if matrix_free:
        t = chunks * bound_s(*power_chunk(b, r, c, k))
    else:
        t = bound_s(*batched_gram(b, r, c)) + chunks * bound_s(
            *gram_chunk(b, c, k))
    return t + bound_s(*abs_rowsum(b, c))


def solve_s(shape, sweeps, k: int, matrix_free: bool) -> float:
    """Least seconds of a whole MSC solve of a tensor of `shape`, given
    each mode's sweeps."""
    return sum(mode_s(tuple(shape[i] for i in perm), s, k, matrix_free)
               for perm, s in zip(MODE_PERMS, sweeps))
