"""MSC over model-derived third-order tensors — counterpart of
`repro/core/integration.py`.

Two tensors a training framework produces anyway:

* activation tensors (layers × tokens × features): triclusters expose
  groups of redundant layers, token positions and feature directions;
* MoE routing tensors (layers × experts × feature bins): triclusters
  expose expert groups with correlated routing.

Both go through the same MSC entry points as the paper's CLI.
`routing_tensor` takes per-layer router probabilities from the caller,
as in the reference, which has no caller that feeds it from its own MoE
router; neither has the port (`models/layers.py:moe_route` gives a
layer's probabilities).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .msc import msc_sequential
from .parallel import build_msc_parallel
from .types import MSCConfig, MSCResult


def collect_activation_tensor(layer_acts: Sequence, max_tokens: int = 512,
                              max_features: int = 512) -> torch.Tensor:
    """Stack per-layer activations into a (layers, tokens, features) tensor.

    layer_acts: one (batch, seq, features) or (tokens, features) tensor or
    array per layer.  Tokens and features are truncated to keep the MSC
    input at diagnostic size; each layer is standardized by its mean and
    its population standard deviation (`jnp.std`'s form), so the MSC noise
    model (a unit-variance background) roughly applies.
    """
    stacked = []
    for a in layer_acts:
        a = torch.as_tensor(a, dtype=torch.float32)
        a = a.reshape(-1, a.shape[-1])[:max_tokens, :max_features]
        sd = torch.std(a, unbiased=False) + 1e-6
        stacked.append((a - torch.mean(a)) / sd)
    return torch.stack(stacked)


def cluster_activations(layer_acts: Sequence,
                        cfg: Optional[MSCConfig] = None, mesh=None,
                        device="cuda", **collect_kw) -> MSCResult:
    """Tricluster an activation tensor: mesh=None → the sequential MSC on
    `device`; a DeviceMesh (`launch/mesh.py`) → the parallel flat
    schedule over it, on the rank's device (every rank calls this with the
    same activations)."""
    cfg = cfg or MSCConfig(epsilon=1e-6)
    tensor = collect_activation_tensor(layer_acts, **collect_kw)
    if mesh is None:
        return msc_sequential(tensor, cfg, device=device)
    return build_msc_parallel(cfg, "flat", mesh=mesh)(tensor)


def routing_tensor(router_probs: Sequence, n_bins: int = 32) -> torch.Tensor:
    """MoE routing statistics tensor (layers, experts, bins).

    router_probs: per-layer (tokens, experts) routing weights.  Token t
    goes to bin t mod n_bins; a bin's routing mass is averaged over its
    tokens and each layer is standardized (population std), a fixed-shape
    summary of which experts fire on which token groups.
    """
    layers = []
    for p in router_probs:
        p = torch.as_tensor(p, dtype=torch.float32)
        t, e = p.shape
        bins = torch.arange(t, device=p.device) % n_bins
        mass = torch.zeros((n_bins, e), device=p.device).index_add_(0, bins, p)
        count = torch.zeros(n_bins, device=p.device).index_add_(
            0, bins, torch.ones(t, device=p.device))
        mass = mass / torch.clamp(count, min=1.0)[:, None]
        mass = (mass - torch.mean(mass)) / (torch.std(mass, unbiased=False)
                                            + 1e-6)
        layers.append(mass.T)
    return torch.stack(layers)


def cluster_experts(router_probs: Sequence, cfg: Optional[MSCConfig] = None,
                    n_bins: int = 32, device="cuda") -> MSCResult:
    """Tricluster the MoE routing tensor on `device`: mode-2 clusters are
    expert groups."""
    cfg = cfg or MSCConfig(epsilon=1e-6)
    return msc_sequential(routing_tensor(router_probs, n_bins), cfg,
                          device=device)
