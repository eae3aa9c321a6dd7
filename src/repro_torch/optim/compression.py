"""Error-feedback top-k gradient compression — counterpart of
`repro/optim/compression.py`.

compressed = topk(grad + residual); residual' = (grad + residual) −
compressed (Stich et al., 2018).  The mask keeps every entry whose |x|
is at least the k-th largest, so ties at the threshold keep more than k
entries, as the reference's do.  k and the threshold are per leaf of the
reference's tree: the layers of a `LayerStack` leaf are one leaf there
(stacked), so they share one threshold here too.  On one device nothing is exchanged: the
step applies the compressed gradient, and the residual carries the rest
to the next step.  On a mesh of ranks each rank holds its shards of the
gradients and the residual; the threshold is the k-th largest |x| of the
whole leaf, its magnitudes gathered from the ranks that cut it, so every
rank keeps what one device would.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.params import map_params, tree_leaves

from .adamw import leaves


class CompressionState(NamedTuple):
    residual: Any  # error-feedback accumulator, congruent with the params


def compress_init(params) -> CompressionState:
    return CompressionState(residual=map_params(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _topk_mask(x: torch.Tensor, frac: float, shards=None,
               held=None) -> torch.Tensor:
    """Mask (in x's dtype) keeping the top `frac` fraction of |x|; with
    `shards`, x is this rank's shard of layout `held` of the leaf whose
    top fraction is kept."""
    mag = torch.abs(x)
    whole = mag
    if shards is not None and held is not None:
        whole = shards.reshard(mag, held, (None,) * mag.dim())
    k = max(1, int(whole.numel() * frac))
    thresh = torch.topk(whole.reshape(-1), k, sorted=False).values.min()
    return (mag >= thresh).to(x.dtype)


def _groups(tree):
    """Indices into `leaves(tree)`, one list per leaf of the reference's
    tree (a `LayerStack` leaf's layers together)."""
    pos = {id(t): i for i, t in enumerate(leaves(tree))}
    return [[pos[id(t)] for t in (e if isinstance(e, list) else [e])]
            for e in tree_leaves(tree)]


@torch.no_grad()
def topk_compress_update(grads, state: CompressionState, frac: float = 0.01,
                         shards=None):
    """Returns (compressed grads, new state): the grads a list in the
    parameters' order, each in its gradient's dtype; the residual is
    updated in place.  With `shards` both are this rank's shards (the
    residual's leaves carry their layouts)."""
    g_all, r_all = leaves(grads), leaves(state.residual)
    sent = [None] * len(g_all)
    for group in _groups(state.residual):
        acc = torch.stack([g_all[i].float() + r_all[i] for i in group])
        held = getattr(r_all[group[0]], "_held", None)
        s = acc * _topk_mask(acc, frac, shards,
                             None if held is None else (None,) + held)
        for j, i in enumerate(group):
            sent[i] = s[j].to(g_all[i].dtype)
            r_all[i].copy_(acc[j] - s[j])
    return sent, state
