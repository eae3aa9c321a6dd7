"""Plain PyTorch Multi-Slice Clustering: the benchmark's reference.

A straightforward implementation of the paper's Alg. 1 (arXiv:2309.17383)
with the convergence gate the program uses, written from the algorithm
and importing nothing of the program.  For each mode j the tensor is
unfolded into slices T_i (m_j, r_j, c_j); the top eigenpair of
C_i = T_iᵀT_i comes from power iteration, either matrix-free
(v ← Tᵀ(T v)) or on the explicit gram C_i; the rows λ_i/λ_max · v_i form
V; d = rowsum |V Vᵀ|; the cluster is the max-gap head of d, trimmed
until Theorem II.1 holds.

The gate: sweeps run in chunks of `check_every`.  The last sweep of a
chunk is the probe: with w = C v at the unit iterate v, λ = vᵀw and
resid = ‖w − λv‖; the solve stops once
max_i (resid_i / max(λ_i, 1)) · λ_i ≤ tol · max_i λ_i, or at the cap
(rounded up to whole chunks).  The final λ is ‖T v‖² (matrix-free) or
vᵀCv (gram), in fp32.

`operand` rounds the operands of every product: the identity for the
fp32 reference; `tf32` for the control, which computes the same
algorithm with TF32 operands and fp32 sums, the precision one step below
the configuration's.  TF32 is always off in the products themselves, so
the reference is fp32 on every card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# transpositions taking T (m1, m2, m3) to its slice-major unfolding
MODE_PERMS = ((0, 1, 2), (1, 0, 2), (2, 0, 1))


@dataclasses.dataclass
class ModeAnswer:
    """One mode's answer on the host: the cluster mask, d, λ and the
    power-iteration sweeps run."""

    mask: np.ndarray
    d: np.ndarray
    lam: np.ndarray
    sweeps: int


def fp32(x: torch.Tensor) -> torch.Tensor:
    return x


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, nearest, ties away), kept in
    an fp32 tensor: what a TF32 product reads of an fp32 operand."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def no_tf32() -> None:
    """Keep cuBLAS and cuDNN from computing fp32 products in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def start_vectors(b: int, c: int, device) -> torch.Tensor:
    """(b, c) unit start vectors: ones + 0.01·sin(1.37·k + 0.3)."""
    k = torch.arange(c, dtype=torch.float32, device=device)
    v = torch.ones(c, dtype=torch.float32, device=device) + 0.01 * torch.sin(
        1.37 * k + 0.3)
    v = v / torch.linalg.vector_norm(v)
    return v.expand(b, c).contiguous()


def _unit(w: torch.Tensor) -> torch.Tensor:
    return w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-30)


def top_eigenpairs(slices: torch.Tensor, *, matrix_free: bool, cap: int,
                   tol: float, check_every: int, operand=fp32):
    """(λ (b,), v (b, c), sweeps) of every slice's C_i = T_iᵀT_i."""
    b, _, c = slices.shape
    s = operand(slices)
    if matrix_free:
        def matvec(v):
            tv = torch.bmm(s, operand(v).unsqueeze(-1))
            return torch.bmm(operand(tv.transpose(1, 2)), s).squeeze(1)
    else:
        gram = torch.bmm(s.transpose(1, 2), s)  # fp32 sums
        g = operand(gram)

        def matvec(v):
            return torch.bmm(g, operand(v).unsqueeze(-1)).squeeze(-1)
    k = max(1, min(check_every, cap))
    v = start_vectors(b, c, slices.device)
    sweeps = 0
    while sweeps < cap:
        for _ in range(k - 1):
            v = _unit(matvec(v))
        w = matvec(v)
        lam = torch.sum(w * v, dim=-1)
        resid = torch.linalg.vector_norm(w - lam[:, None] * v, dim=-1)
        v = _unit(w)
        sweeps += k
        weighted = torch.amax(resid / torch.clamp(lam, min=1.0) * lam)
        if tol > 0 and bool(weighted <= tol * torch.clamp(torch.amax(lam),
                                                          min=1e-30)):
            break
    if matrix_free:
        tv = torch.bmm(slices, v.unsqueeze(-1)).squeeze(-1)
        lam = torch.sum(tv * tv, dim=-1)
    else:
        lam = torch.sum(v * torch.bmm(gram, v.unsqueeze(-1)).squeeze(-1),
                        dim=-1)
    return lam, v, sweeps


def marginal_sums(lam: torch.Tensor, v: torch.Tensor, operand=fp32):
    """d_i = Σ_j |V Vᵀ|_ij with V's rows λ_i / λ_max · v_i."""
    rows = (lam / torch.clamp(torch.amax(lam), min=1e-30))[:, None] * v
    rows = operand(rows)
    return torch.sum(torch.abs(rows @ rows.T), dim=1)


def theorem_thresholds(m: int, epsilon: float) -> np.ndarray:
    """Theorem II.1's bound l·ε/2 + sqrt(log(m − l)) (m − l at least 2)
    for every cluster size l = 0…m, in fp32."""
    l = torch.arange(m + 1, dtype=torch.float32)
    eps = torch.tensor(epsilon, dtype=torch.float32)
    gap = torch.clamp(torch.tensor(float(m)) - l, min=2.0)
    return (l * eps / 2.0 + torch.sqrt(torch.log(gap))).numpy()


def extract(d: np.ndarray, epsilon: float, max_iters: int = 0) -> np.ndarray:
    """The cluster of d: everything above the largest gap of d sorted
    decreasing (the first such gap), then, while the spread of d over the
    cluster exceeds Theorem II.1's bound and more than one member is
    left, drop the member with the least d (the lowest index on ties), at
    most max_iters times (0: m)."""
    m = d.shape[0]
    order = np.argsort(-d, kind="stable")
    ds = d[order]
    k = int(np.argmax(ds[:-1] - ds[1:])) if m > 1 else 0
    mask = d >= ds[k]
    thr = theorem_thresholds(m, epsilon)
    members = sorted(np.flatnonzero(mask), key=lambda i: (d[i], i))
    hi = d[members[-1]]
    for _ in range(max_iters if max_iters > 0 else m):
        l = len(members)
        if l <= 1 or not np.float32(hi - d[members[0]]) > thr[l]:
            break
        mask[members.pop(0)] = False
    return mask


def solve(tensor: torch.Tensor, cfg: dict, operand=fp32) -> list:
    """The three modes' answers for one tensor, under `cfg` (the
    configuration's solver settings: matrix_free, power_iters,
    power_tol, power_check_every, epsilon, max_extraction_iters)."""
    no_tf32()
    out = []
    for perm in MODE_PERMS:
        slices = tensor.permute(perm).contiguous()
        lam, v, sweeps = top_eigenpairs(
            slices, matrix_free=cfg["matrix_free"], cap=cfg["power_iters"],
            tol=cfg["power_tol"], check_every=cfg["power_check_every"],
            operand=operand)
        del slices
        d = marginal_sums(lam, v, operand).cpu().numpy()
        out.append(ModeAnswer(
            mask=extract(d, cfg["epsilon"], cfg["max_extraction_iters"]),
            d=d, lam=lam.cpu().numpy(), sweeps=int(sweeps)))
    return out
