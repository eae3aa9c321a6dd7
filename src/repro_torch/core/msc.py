"""Sequential MSC (paper Alg. 1) — counterpart of `repro/core/msc.py`.

For mode j the tensor is unfolded into `slices` of shape (m_j, r_j, c_j)
whose i-th entry is the paper's slice T_i; its covariance is
C_i = T_iᵀT_i.  V is stored row-major (row i = λ̃_i ṽ_i), so the paper's
C = |VᵀV| is |V Vᵀ| here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .extraction import extract_cluster
from .power_iter import compute_dtype, top_eigenpairs
from .types import ModeResult, MSCConfig, MSCResult, resolve_device

# Transpositions taking T (m1, m2, m3) to (m_j, r_j, c_j) slice-major form.
MODE_PERMS = ((0, 1, 2), (1, 0, 2), (2, 0, 1))


def mode_slices(tensor: torch.Tensor, mode: int) -> torch.Tensor:
    """Contiguous (m_j, r_j, c_j) slice-major copy of the tensor for mode j
    (no copy for mode 0), the layout the power-iteration kernel reads."""
    return tensor.permute(MODE_PERMS[mode]).contiguous()


def normalized_eigrows(slices: torch.Tensor, cfg: MSCConfig,
                       valid_mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rows λ̃_i ṽ_i of V.  Returns (V (m, c), lambdas (m,), sweeps as a
    0-d int device tensor).

    Padded slices (valid_mask False) get zero rows and are left out of
    the fp32 λ_max normalization."""
    lam, vec, p_iters = top_eigenpairs(slices, cfg)
    zero = torch.zeros((), dtype=lam.dtype, device=lam.device)
    if valid_mask is not None:
        lam = torch.where(valid_mask, lam, zero)
    lam_max = torch.clamp(torch.max(lam), min=1e-30)
    v_rows = (lam / lam_max)[:, None] * vec
    if valid_mask is not None:
        v_rows = torch.where(valid_mask[:, None], v_rows, zero)
    return v_rows, lam, p_iters


def similarity_matrix(v_rows: torch.Tensor,
                      precision: str = "fp32") -> torch.Tensor:
    """C = |V Vᵀ| with precision-policy operands and an fp32 product."""
    v = v_rows.to(compute_dtype(precision)).float()
    return torch.abs(v @ v.T)


def marginal_sums(v_rows: torch.Tensor,
                  valid_mask: Optional[torch.Tensor] = None,
                  precision: str = "fp32") -> torch.Tensor:
    """d_i = Σ_j c_ij (a plain product on both paths, as in the reference)."""
    c = similarity_matrix(v_rows, precision)
    if valid_mask is not None:
        c = torch.where(valid_mask[None, :], c,
                        torch.zeros((), dtype=c.dtype, device=c.device))
    return torch.sum(c, dim=1)


def cluster_mode_slices(slices: torch.Tensor, cfg: MSCConfig,
                        valid_mask: Optional[torch.Tensor] = None
                        ) -> ModeResult:
    """Cluster one mode given its slice-major tensor (m, r, c)."""
    v_rows, lam, p_iters = normalized_eigrows(slices, cfg, valid_mask)
    d = marginal_sums(v_rows, valid_mask, cfg.precision)
    mask, n_iters = extract_cluster(d, cfg.epsilon, valid_mask,
                                    cfg.max_extraction_iters)
    return ModeResult(mask=mask, d=d, lambdas=lam, n_iters=n_iters,
                      power_iters_run=p_iters)


def _on_device(tensor, device) -> torch.Tensor:
    return torch.as_tensor(tensor).to(resolve_device(device))


def msc_sequential(tensor, cfg: MSCConfig, device="cuda") -> MSCResult:
    """Full MSC (paper Alg. 1): cluster all three modes of `tensor` on
    `device` (a torch tensor or numpy array; moved there if needed)."""
    t = _on_device(tensor, device)
    return MSCResult(modes=tuple(
        cluster_mode_slices(mode_slices(t, j), cfg) for j in range(3)))


def msc_similarity_matrices(tensor, cfg: MSCConfig, device="cuda"):
    """Per-mode similarity matrices C (for the sim metric, Eq. 6)."""
    t = _on_device(tensor, device)
    out = []
    for j in range(3):
        v_rows, _, _ = normalized_eigrows(mode_slices(t, j), cfg)
        out.append(similarity_matrix(v_rows, cfg.precision))
    return tuple(out)
