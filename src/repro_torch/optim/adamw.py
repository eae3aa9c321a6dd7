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


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ g²) over every leaf, in fp32."""
    total = None
    for g in leaves(tree):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig):
    """One AdamW step.  grads: a tree or sequence in the parameters'
    order.  Updates `params`, `state.m` and `state.v` in place and
    returns (params, new state, {"grad_norm", "lr"}), the metrics 0-d
    fp32 tensors."""
    step = state.step + 1
    gnorm = global_norm(grads)
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
