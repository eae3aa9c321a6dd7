"""Cluster-quality metrics (paper Eq. 6): recovery rate and similarity index."""
from __future__ import annotations

import torch


def recovery_rate(true_masks, pred_masks) -> torch.Tensor:
    """rec = (1/3) Σ_k |J_k ∩ Ĵ_k| / |J_k| over boolean membership masks."""
    per_mode = []
    for t, p in zip(true_masks, pred_masks):
        t = t.to(torch.float32)
        p = p.to(device=t.device, dtype=torch.float32)
        per_mode.append(torch.sum(t * p) / torch.clamp(torch.sum(t), min=1.0))
    return torch.mean(torch.stack(per_mode))


def similarity_index_mode(c_full, pred_mask) -> torch.Tensor:
    """sim_k = (1/|Ĵ|²) Σ_{i,j∈Ĵ} c_ij for one mode's C = |V Vᵀ|."""
    p = pred_mask.to(device=c_full.device, dtype=torch.float32)
    l = torch.clamp(torch.sum(p), min=1.0)
    return torch.einsum("i,ij,j->", p, c_full, p) / (l * l)


def similarity_index(c_mats, pred_masks) -> torch.Tensor:
    """sim = (1/3) Σ_k sim_k (paper Eq. 6, right)."""
    vals = [similarity_index_mode(c, p) for c, p in zip(c_mats, pred_masks)]
    return torch.mean(torch.stack(vals))
