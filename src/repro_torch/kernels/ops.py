"""Dispatchers in front of the CUDA kernels (counterpart of `repro/kernels/ops.py`).

A tensor on `cuda` runs the hand-written kernel or raises; only a tensor
on the CPU takes the kernel's plain version (inside the wrappers in
`power_iter.py`, `ring.py`, `gram.py` and `flash_attention.py`).  There
is no fallback from one to the other.
"""
from __future__ import annotations

import dataclasses

import torch

from . import flash_attention as _fa
from . import gram as _gram
from . import power_iter as _pi
from . import ring as _ring


def batched_gram(slices: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """Batched slice covariance C_i = T_iᵀT_i (see gram.py).

    A leading request dim (B, b, r, c) flattens into the kernel's slice
    axis and unflattens on exit."""
    lead = slices.shape[:-3]
    if lead:
        flat = batched_gram(slices.reshape((-1,) + slices.shape[-2:]),
                            out_dtype=out_dtype)
        return flat.reshape(lead + (slices.shape[-3],) + flat.shape[1:])
    return _gram.batched_gram(slices, out_dtype=out_dtype)


def flash_attention(q, k, v, *, causal=True, scale=None, q_offset=0,
                    window=None, softcap=None):
    """Fused flash attention (see flash_attention.py); the kernel's tiles
    are fixed by d, so the reference's block_q / block_k hints have no
    counterpart."""
    return _fa.flash_attention(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset, window=window,
                               softcap=softcap)


def abs_rowsum(a: torch.Tensor, b: torch.Tensor, acc=None, *,
               block_i: int = 128, block_j: int = 128) -> torch.Tensor:
    """acc + Σ_j |a bᵀ|_{:,j} (see ring.py)."""
    return _ring.abs_rowsum(a, b, acc, block_i=block_i, block_j=block_j)


def _summed_matvec(s: torch.Tensor, inner_group, block_r: int, route=None):
    """matvec(v) = one `power_matvec` launch on this rank's rows of the
    slices, all-reduced over the inner group."""
    from repro_torch.core.power_iter import _psum_inner

    def matvec(v):
        return _psum_inner(_pi.power_matvec(s, v, block_r=block_r,
                                            route=route), inner_group)

    return matvec


def build_chunk_fn(slices: torch.Tensor, k: int, *, precision: str = "fp32",
                   inner_group=None, block_r: int = 256, route=None):
    """chunk_fn(v) -> (v_new, lam, resid): k fused sweeps and the gate
    probe in one kernel launch — the kernel form of
    `core.power_iter.make_chunk_probe`.  With an inner group (slices
    sharded by rows) no sweep can be fused: each needs the all_reduce of
    the partial w = Tᵀ(T v) before it normalizes, so the chunk drops to
    one `power_matvec` launch per sweep plus the all_reduce.  `route`
    forces the kernel's route (None: its own pick)."""
    from repro_torch.core.power_iter import compute_dtype, make_chunk_probe

    s = slices.to(compute_dtype(precision)).contiguous()
    if inner_group is not None:
        return make_chunk_probe(_summed_matvec(s, inner_group, block_r, route),
                                k)

    def chunk_fn(v):
        return _pi.power_iterate_chunk(s, v, k, block_r=block_r, route=route)

    return chunk_fn


def plan_matrix_free(slices: torch.Tensor, n_iters: int = 60,
                     tol: float = 0.0, check_every: int = 6,
                     precision: str = "fp32", c_valid=None,
                     slice_group=None, inner_group=None, *,
                     block_r: int = 256):
    """The fused solve (`core.power_iter.Eigensolve`) with the same start
    vectors, gate and `iters` semantics as
    `core.power_iter.plan_matrix_free`.

    tol <= 0: one launch of n_iters sweeps plus the λ pass (λ re-measured
    in fp32 under bf16).  tol > 0: one launch per gate chunk of
    check_every sweeps, the gate all-reduced over `slice_group`.  With an
    `inner_group`, one `power_matvec` launch and one all_reduce per sweep
    (see `build_chunk_fn`), and λ = ‖T v‖² summed over the group.
    """
    from repro_torch.core.power_iter import (Eigensolve, _adaptive,
                                             _init_vectors, compute_dtype,
                                             gated_solve, rayleigh_fp32)

    v0 = _init_vectors(slices.shape[:-2], slices.shape[-1], torch.float32,
                       c_valid, device=slices.device)
    if inner_group is not None:
        s = slices.to(compute_dtype(precision)).contiguous()
        return _adaptive(_summed_matvec(s, inner_group, block_r), v0,
                         n_iters, tol, check_every,
                         lambda st: rayleigh_fp32(slices, st.v, inner_group),
                         slice_group)
    if tol <= 0.0:
        s = slices.to(compute_dtype(precision)).contiguous()

        def step(state):
            lam, v = _pi.power_iterate(s, state.v, n_iters, block_r=block_r)
            return dataclasses.replace(
                state, v=v, lam=lam,
                iters=torch.full_like(state.iters, n_iters))

        def finish(state):
            if precision == "fp32":
                return state.lam
            return rayleigh_fp32(slices, state.v)

        return Eigensolve(v0, step, finish, n_iters, gated=False)
    k = max(1, min(check_every, n_iters))
    return gated_solve(v0, build_chunk_fn(slices, k, precision=precision,
                                          block_r=block_r),
                       k, n_iters, tol, lambda st: rayleigh_fp32(slices, st.v),
                       slice_group)


def power_iterate_matrix_free(slices: torch.Tensor, n_iters: int = 60,
                              tol: float = 0.0, check_every: int = 6,
                              precision: str = "fp32", c_valid=None,
                              slice_group=None, inner_group=None, *,
                              block_r: int = 256):
    """Fused power iteration (`plan_matrix_free`, run eagerly).
    Returns (lam (..., b), v (..., b, c), iters with the request shape).
    """
    return plan_matrix_free(slices, n_iters, tol, check_every, precision,
                            c_valid, slice_group, inner_group,
                            block_r=block_r).run()
