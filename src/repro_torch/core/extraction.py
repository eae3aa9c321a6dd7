"""Cluster extraction from the marginal-similarity vector d (paper Alg. 1).

Counterpart of `repro/core/extraction.py`:

1. Max-gap initialization: sort d decreasing, take everything above the
   largest consecutive gap.
2. Theorem II.1 trimming: while max_{i,n∈J} |d_i − d_n| exceeds
   l·ε/2 + sqrt(log(m − l)), drop the member with the smallest d.

Masks and counts stay on d's device, with no read back to the host.
The sorts are stable and argmax/argmin resolve ties to the first index,
as in JAX, so both packages pick the same members.  `valid_mask` marks
padding (False), which never enters J and does not count in m.  A
leading dim of d batches independent requests.
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
    """Initial cluster mask via the max gap of sorted d (paper Alg. 1).

    d (..., m): leading dims are independent requests."""
    m = d.shape[-1]
    valid_mask = _valid(d, valid_mask)
    n_valid = valid_mask.sum(-1, keepdim=True)
    dm = torch.where(valid_mask, d, torch.full_like(d, _NEG))
    order = torch.argsort(-dm, dim=-1, stable=True)  # decreasing, as jnp
    ds = torch.gather(dm, -1, order)
    gaps = ds[..., :-1] - ds[..., 1:]
    # only gaps between two valid entries may split the cluster off
    pos_ok = torch.arange(1, m, device=d.device) < n_valid
    gaps = torch.where(pos_ok, gaps, torch.full_like(gaps, -1.0))
    k = torch.argmax(gaps, dim=-1, keepdim=True)  # first maximal gap
    return (dm >= torch.gather(ds, -1, k)) & valid_mask


def trim_to_theorem(d: torch.Tensor, init_mask: torch.Tensor,
                    epsilon: float,
                    valid_mask: Optional[torch.Tensor] = None,
                    max_iters: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Theorem II.1 trimming.  Returns (final mask, n_iters int32 tensor).

    The reference's `lax.while_loop` drops the argmin-d member of J while
    the spread of d over J exceeds the bound and |J| > 1, at most
    `max_iters` times (0 → m).  Each step drops the current minimum and,
    while more than one member is left, never the maximum; so after t
    drops J is the init mask less its t smallest members (in a stable
    ascending sort: ties go by index, as argmin breaks them) and the
    spread is max − d₍t₎.  The trim count is the first t whose bound
    holds, found in one sort with no read back to the host.  The spread
    and `theorem_threshold` take the same fp32 operations as the loop's.
    d (..., m): leading dims are independent requests.
    """
    m = d.shape[-1]
    valid_mask = _valid(d, valid_mask)
    cap = max_iters if max_iters > 0 else m
    n_valid = valid_mask.to(torch.float32).sum(-1, keepdim=True)
    # members ascending, non-members after them
    key = torch.where(init_mask, d, torch.full_like(d, -_NEG))
    order = torch.argsort(key, dim=-1, stable=True)
    lo = torch.gather(key, -1, order)  # lo[..., t]: min of J after t drops
    n_init = init_mask.sum(-1, keepdim=True)
    hi = torch.gather(lo, -1, (n_init - 1).clamp(min=0))  # max of J
    t = torch.arange(m, device=d.device)
    l = (n_init - t).to(torch.float32)
    violated = ((hi - lo > theorem_threshold(l, n_valid, epsilon))
                & (l > 1.0) & (t < cap))
    # the loop's count: the first t whose bound holds (t = L − 1 always does)
    n_iters = torch.argmax((~violated).to(torch.int32), dim=-1)
    dropped = torch.zeros_like(init_mask).scatter(
        -1, order, t < n_iters[..., None])
    return init_mask & ~dropped, n_iters.to(torch.int32)


def extract_cluster(d: torch.Tensor, epsilon: float,
                    valid_mask: Optional[torch.Tensor] = None,
                    max_iters: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max-gap init + theorem trimming.  Returns (bool mask (..., m),
    n_iters int32 (...)), both on d's device."""
    init = max_gap_init(d, valid_mask)
    return trim_to_theorem(d, init, epsilon, valid_mask, max_iters)
