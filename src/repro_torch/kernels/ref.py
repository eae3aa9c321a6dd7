"""Plain PyTorch versions of the CUDA kernels on the port's path.

Each function computes exactly what its kernel computes, in the same
precision: operands are rounded to the input's dtype (fp32 or bf16) at
the places the kernel rounds them, and every product and sum runs in
fp32.  `torch.einsum` on bf16 tensors would return bf16, so the bf16
operands enter an fp32 product as `x.to(bfloat16).float()`, the plain
form of `preferred_element_type=float32`.

The kernel wrappers (`power_iter.py`, `ring.py`, `gram.py`,
`flash_attention.py`) call these
for tensors on the CPU; `chip_smoke.py` holds each kernel against them
on the card.
"""
from __future__ import annotations

from typing import Optional

import torch


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round an fp32 tensor to the operand dtype and back to fp32."""
    return x.to(dtype).float()


def power_sweeps(slices: torch.Tensor, v0: torch.Tensor, n_upd: int, *,
                 lambda_pass: bool, emit_gate: bool, normalize: bool = True):
    """The fused sweep body shared by the three entry points.

    slices (..., b, r, c) in fp32 or bf16; v0 (..., b, c) fp32.  Runs
    n_upd sweeps of w = Tᵀ round(T round(v)) (normalizing v ← w/(‖w‖+1e-30)
    when `normalize`), then optionally a λ = ‖T round(v)‖² pass.  With
    `emit_gate`, λ = vᵀw and resid = ‖w − λv‖ from the last sweep, before
    normalizing.  Returns (lam, v, resid, w), all fp32.
    """
    dt = slices.dtype
    s = slices.float()
    v = v0.float()
    lam = torch.zeros(v.shape[:-1], dtype=torch.float32, device=v.device)
    resid = torch.zeros_like(lam)
    w = torch.zeros_like(v)
    for it in range(n_upd):
        tv = (s @ _round(v, dt).unsqueeze(-1)).squeeze(-1)
        w = (_round(tv, dt).unsqueeze(-2) @ s).squeeze(-2)
        if emit_gate and it == n_upd - 1:
            lam = torch.sum(w * v, dim=-1)
            resid = torch.sqrt(torch.sum((w - lam[..., None] * v) ** 2,
                                         dim=-1))
        if normalize:
            v = w / (torch.sqrt(torch.sum(w * w, dim=-1, keepdim=True))
                     + 1e-30)
    if lambda_pass:
        tv = (s @ _round(v, dt).unsqueeze(-1)).squeeze(-1)
        lam = torch.sum(tv * tv, dim=-1)
    return lam, v, resid, w


def power_iterate(slices: torch.Tensor, v0: torch.Tensor, n_iters: int):
    """n_iters sweeps then λ = ‖T v‖².  Returns (lam (..., b), v (..., b, c))."""
    lam, v, _, _ = power_sweeps(slices, v0, n_iters, lambda_pass=True,
                                emit_gate=False)
    return lam, v


def power_iterate_chunk(slices: torch.Tensor, v: torch.Tensor, k: int):
    """k sweeps with the gate probe.  Returns (v_new, lam, resid)."""
    lam, v_new, resid, _ = power_sweeps(slices, v, k, lambda_pass=False,
                                        emit_gate=True)
    return v_new, lam, resid


def power_iterate_adaptive(slices: torch.Tensor, v0: torch.Tensor,
                           n_iters: int, tol: float, check_every: int = 6):
    """The convergence-gated power iteration as a host-side oracle (the
    reference's `kernels/ref.py:power_iterate_adaptive`).

    Runs check_every-sweep chunks in fp32; each chunk's last matvec is the
    probe: with w = C v at the pre-normalization iterate, λ = vᵀw and
    resid = ‖w − λv‖, and the loop stops once
    max_i resid_i/max(λ_i, 1)·λ_i ≤ tol · max(λ_max, 1e-30).  The cap
    rounds up to a multiple of check_every.  Returns (lam (b,), v (b, c),
    iters int), λ re-measured as ‖T v‖² at the final v.
    """
    s = slices.float()
    v = v0.float()
    k = max(1, min(check_every, n_iters))
    it = 0

    def matvec(x):
        return torch.einsum("brc,br->bc", s, torch.einsum("brc,bc->br", s, x))

    while it < n_iters:
        for _ in range(k - 1):
            w = matvec(v)
            v = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-30)
        w = matvec(v)
        lam = torch.sum(w * v, dim=-1)
        resid = torch.linalg.vector_norm(w - lam[:, None] * v, dim=-1)
        v = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-30)
        it += k
        weighted = torch.max(resid / torch.clamp(lam, min=1.0) * lam)
        if float(weighted) <= tol * float(torch.clamp(torch.max(lam),
                                                      min=1e-30)):
            break
    tv = torch.einsum("brc,bc->br", s, v)
    return torch.sum(tv * tv, dim=-1), v, it


def power_matvec(slices: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One unnormalized sweep: w = Tᵀ(T v) in fp32."""
    _, _, _, w = power_sweeps(slices, v, 1, lambda_pass=False,
                              emit_gate=False, normalize=False)
    return w


def abs_rowsum(a: torch.Tensor, b: torch.Tensor,
               acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """acc + Σ_j |a bᵀ|_{:,j} with an fp32 product and accumulator.

    a (bl, c), b (bc, c), acc (bl,) or None; batched a (B, bl, c),
    b (B, bc, c), acc (B, bl) keeps requests apart.  Returns fp32.
    """
    d = torch.abs(a.float() @ b.float().transpose(-1, -2)).sum(dim=-1)
    return d if acc is None else acc.float() + d


def similarity_rowsum(v_local: torch.Tensor,
                      v_full: torch.Tensor) -> torch.Tensor:
    """d_local = Σ_j |V_local V_fullᵀ|_{:,j}: v_local (bl, c) this rank's
    rows of V, v_full (m, c) the gathered V.  Returns (bl,) fp32."""
    return abs_rowsum(v_local, v_full)


def ring_rowsum(v_chunks, start: int = 0) -> torch.Tensor:
    """Ring-schedule row sums of rank `start`: its own chunk first, then
    the chunks of start−1, start−2, … as they arrive around the ring (the
    summation order of `core/schedule.py:_ring_rowsum`).  v_chunks: the p
    (m/p, c) chunks of V in rank order."""
    p = len(v_chunks)
    d = abs_rowsum(v_chunks[start], v_chunks[start])
    for step in range(1, p):
        d = abs_rowsum(v_chunks[start], v_chunks[(start - step) % p], d)
    return d


def batched_gram(slices: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """C_i = T_iᵀ T_i: (..., r, c) → (..., c, c).

    Operands keep the input dtype (fp32 or bf16, upcast exactly for the
    product), every product and sum is fp32, and the result is cast to
    `out_dtype` (default: the input dtype), as the Pallas kernel does.
    """
    s = slices.float()
    return (s.transpose(-1, -2) @ s).to(out_dtype or slices.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Attention with the flash kernel's masks, in fp32.

    q (b, sq, d), k / v (b, skv, d) → (b, sq, d) in q's dtype.  Query row
    i sits at global position q_offset + i; `causal` keeps keys at or
    before it, `window` W only the last W of those; `softcap` t maps a
    score s to t·tanh(s/t).  Masked scores are -1e30, and the result is
    Σ p v / (Σ p + 1e-30) with p = exp(s − max s), as the kernel
    normalizes it.
    """
    sq, d = q.shape[-2:]
    skv = k.shape[-2]
    scale = d ** -0.5 if scale is None else scale
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = (p @ v.float()) / (p.sum(dim=-1, keepdim=True) + 1e-30)
    return out.to(q.dtype)
