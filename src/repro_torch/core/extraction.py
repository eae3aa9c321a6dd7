"""Cluster extraction from the marginal-similarity vector d (paper Alg. 1).

Counterpart of `repro/core/extraction.py`:

1. Max-gap initialization: sort d decreasing, take everything above the
   largest consecutive gap.
2. Theorem II.1 trimming: while max_{i,n∈J} |d_i − d_n| exceeds
   l·ε/2 + sqrt(log(m − l)), drop the member with the smallest d.

Masks stay on d's device.  The sort is stable and argmax/argmin resolve
ties to the first index, as in JAX, so both packages pick the same
members.  `valid_mask` marks padding (False), which never enters J and
does not count in m.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .stats import theorem_threshold

_NEG = -1e30  # effective -inf for masked reductions (fp32-safe)


def _valid(d: torch.Tensor, valid_mask) -> torch.Tensor:
    if valid_mask is None:
        return torch.ones(d.shape, dtype=torch.bool, device=d.device)
    return valid_mask.to(d.device)


def max_gap_init(d: torch.Tensor,
                 valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Initial cluster mask via the max gap of sorted d (paper Alg. 1)."""
    m = d.shape[0]
    valid_mask = _valid(d, valid_mask)
    n_valid = valid_mask.sum()
    neg = torch.full_like(d, _NEG)
    dm = torch.where(valid_mask, d, neg)
    order = torch.argsort(-dm, stable=True)  # decreasing, stable like jnp
    ds = dm[order]
    gaps = ds[:-1] - ds[1:]
    # only gaps between two valid entries may split the cluster off
    pos_ok = torch.arange(1, m, device=d.device) < n_valid
    gaps = torch.where(pos_ok, gaps, torch.full_like(gaps, -1.0))
    k = torch.argmax(gaps)  # first maximal gap, as jnp.argmax
    return (dm >= ds[k]) & valid_mask


def _spread(d: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """max_{i,n in mask} |d_i − d_n| = max(d[mask]) − min(d[mask])."""
    hi = torch.max(torch.where(mask, d, torch.full_like(d, _NEG)))
    lo = torch.min(torch.where(mask, d, torch.full_like(d, -_NEG)))
    return hi - lo


def trim_to_theorem(d: torch.Tensor, init_mask: torch.Tensor,
                    epsilon: float,
                    valid_mask: Optional[torch.Tensor] = None,
                    max_iters: int = 0) -> Tuple[torch.Tensor, int]:
    """Theorem II.1 trimming loop.  Returns (final mask, n_iters).

    The reference's `lax.while_loop` becomes a loop over masks on d's
    device; its condition is read back once per iteration (each
    iteration drops one member, so there are at most m).
    """
    m = d.shape[0]
    valid_mask = _valid(d, valid_mask)
    cap = max_iters if max_iters > 0 else m
    n_valid = valid_mask.to(torch.float32).sum()
    plus_inf = torch.full_like(d, -_NEG)
    mask = init_mask.clone()
    it = 0
    while it < cap:
        l = mask.to(torch.float32).sum()
        bound = theorem_threshold(l, n_valid, epsilon)
        if not bool((_spread(d, mask) > bound) & (l > 1.0)):
            break
        mask[torch.argmin(torch.where(mask, d, plus_inf))] = False
        it += 1
    return mask, it


def extract_cluster(d: torch.Tensor, epsilon: float,
                    valid_mask: Optional[torch.Tensor] = None,
                    max_iters: int = 0) -> Tuple[torch.Tensor, int]:
    """Max-gap init + theorem trimming.  Returns (bool mask (m,), n_iters)."""
    init = max_gap_init(d, valid_mask)
    return trim_to_theorem(d, init, epsilon, valid_mask, max_iters)
