"""AdamW with decoupled weight decay and global-norm clipping —
counterpart of `repro/optim/adamw.py`.

The state is congruent with the parameters: `m` and `v` are fp32 trees
of the parameters' structure (`models/params.py:map_params`), so a
checkpoint holds them leaf for leaf beside the parameters, in the
reference's order.  The update follows the reference's operation order:
clip by the global norm, fp32 moments, bias corrections from an fp32
step, decoupled weight decay on fp32 masters, the result cast back to
the parameter's dtype.  Parameters and moments are updated in place, so
a step allocates only its temporaries.

On a mesh of ranks (`shards`, the train step's `LMShards`) parameters,
gradients and moments are the rank's shards and the update is
elementwise on them; the global norm sums each leaf's squares over the
ranks that cut it (one all_reduce per kind of cut), so each element
counts once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.models.params import map_params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def __hash__(self):
        return hash((self.lr, self.b1, self.b2, self.eps, self.weight_decay,
                     self.clip_norm, id(self.schedule)))


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    m: Any
    v: Any


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a parameter tree (an `nn.Module`) or of a sequence,
    in the tree's own order (`parameters()`)."""
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    return list(tree)


def adamw_init(params) -> AdamWState:
    """Zero fp32 moments of the parameters' structure, on their device."""

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = next(iter(leaves(params)))
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=map_params(zeros, params), v=map_params(zeros, params))


def global_norm(tree, shards=None, helds=None) -> torch.Tensor:
    """sqrt(Σ g²) over every leaf, in fp32, the leaves added in order.
    With `shards`, each leaf is this rank's shard under its layout in
    `helds` (one per leaf): its sum of squares is summed over the mesh
    dims that cut it before the leaves are added."""
    sqs = [torch.sum(torch.square(g.float())) for g in leaves(tree)]
    if shards is not None:
        sqs = _summed_over_cuts(sqs, shards, helds)
    total = None
    for sq in sqs:
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _summed_over_cuts(sqs, shards, helds):
    """Each per-leaf value summed over the ranks of the mesh dims that cut
    its leaf: one all_reduce per kind of cut, of every value at once (the
    others zero, so every sum is exact in its own order)."""
    from repro_torch.sharding.activation import spec_axes, spec_entry

    kinds = []
    for held in helds:
        cut = {a for h in (held or ()) for a in spec_axes(h)}
        kinds.append(tuple(a for a in shards.dims if a in cut))
    vec = torch.stack(sqs)
    out = None
    for kind in dict.fromkeys(kinds):
        mask = torch.tensor([k == kind for k in kinds], device=vec.device)
        part = torch.where(mask, vec, torch.zeros((), device=vec.device))
        if kind:
            part = shards._all_reduce(part, spec_entry(kind))
        out = part if out is None else out + part
    return list(out.unbind())


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig,
                 shards=None):
    """One AdamW step.  grads: a tree or sequence in the parameters'
    order.  Updates `params`, `state.m` and `state.v` in place and
    returns (params, new state, {"grad_norm", "lr"}), the metrics 0-d
    fp32 tensors.  With `shards` every tensor is this rank's shard (the
    parameters carry their layouts)."""
    step = state.step + 1
    helds = None if shards is None else \
        [getattr(p, "_held", None) for p in leaves(params)]
    gnorm = global_norm(grads, shards, helds)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    if cfg.schedule is None:
        lr = torch.tensor(cfg.lr, dtype=torch.float32, device=gnorm.device)
    else:
        lr = cfg.schedule(step).float()

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        g = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.float()
        p.copy_((pf - lr * (delta + cfg.weight_decay * pf)).to(p.dtype))
    state.step.copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
