"""State carried across from the JAX reference to the port.

MSC has no weights: what carries over is the configuration, the input
tensor and the eigensolver's carry.  The LM side carries its
`ModelConfig` and its parameters.  Everything crosses as plain Python
values or numpy arrays, so this module needs neither package's internals.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.power_iter import SolveState
from .core.types import MSCConfig
from .models import ModelConfig, model_defs
from .models.params import build


def config_from_fields(fields: dict) -> MSCConfig:
    """MSCConfig from `dataclasses.asdict` of the reference's MSCConfig;
    a field the port does not know raises."""
    known = {f.name for f in dataclasses.fields(MSCConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown MSCConfig fields: {unknown}")
    return MSCConfig(**fields)


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """A torch tensor on `device` holding a copy of the numpy array `a`."""
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def solve_state_from_numpy(v, lam, resid, iters, done,
                           device="cpu") -> SolveState:
    """SolveState from the reference's carry fields, as numpy arrays."""
    return SolveState(
        v=tensor_from_numpy(np.asarray(v, np.float32), device),
        lam=tensor_from_numpy(np.asarray(lam, np.float32), device),
        resid=tensor_from_numpy(np.asarray(resid, np.float32), device),
        iters=tensor_from_numpy(np.asarray(iters, np.int32), device),
        done=tensor_from_numpy(np.asarray(done, bool), device))


def lm_config_from_fields(fields: dict) -> ModelConfig:
    """ModelConfig from `dataclasses.asdict` of the reference's
    ModelConfig; a field the port does not know raises."""
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown ModelConfig fields: {unknown}")
    return ModelConfig(**fields)


def _numpy_leaf(tree, path, shape) -> np.ndarray:
    """The reference's parameter at the port's `path`: the stacked
    `layers` / `enc_layers` (a leading layer dim) indexed by the path's
    layer index; its shape must match the port's def."""
    node, layer = tree, None
    for key in path:
        if isinstance(key, int) and isinstance(node, dict):
            layer = key  # a stacked block: index its leaves' first dim
        else:
            node = node[key]
    a = np.asarray(node) if layer is None else np.asarray(node)[layer]
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"parameter {'/'.join(map(str, path))}: shape "
                         f"{a.shape}, the port's def {shape}")
    return a


def lm_params_from_numpy(cfg: ModelConfig, tree, device="cpu", mesh=None):
    """The port's parameter modules holding the reference's parameter
    pytree (nested dicts and tuples of numpy arrays, e.g.
    `jax.tree.map(np.asarray, params)`).  The reference's stacked
    `layers` / `enc_layers` (a leading layer dim) become one module per
    layer, the `tail` tuple one module per entry; every leaf crosses
    as it is (the stacked expert weights (E, d, f), the `shared` MLP,
    the SSM and RG-LRU leaves among them) and every shape must match the
    port's defs.

    With `mesh` (an LM serving mesh, `launch/mesh.py:make_local_mesh`)
    each rank gets only its shards under the serve rules' `param_specs`,
    cut from the numpy arrays before they reach the device (for
    `ServeEngine(..., mesh=mesh)`)."""
    defs = model_defs(cfg)
    if mesh is not None:
        from .models import Model
        from .serving.engine import shard_params
        from .sharding.activation import LMShards
        from .sharding.specs import param_specs, rules_for

        specs = param_specs(defs, mesh, rules_for(cfg.zero_shard, serve=True))
        return shard_params(
            Model(cfg), lambda d, path: _numpy_leaf(tree, path, d.shape),
            LMShards(mesh, ()), specs, device)

    def make(d, path):
        return torch.from_numpy(np.array(_numpy_leaf(tree, path, d.shape),
                                         dtype=np.float32)).to(device,
                                                                d.dtype)

    return build(defs, make)


def train_state_from_numpy(cfg: ModelConfig, params, step, m, v,
                           residual=None, device="cpu", mesh=None):
    """The port's `TrainState` holding the reference's: its parameters,
    AdamW step and moments m, v, and the optional compression residual,
    each a pytree as `lm_params_from_numpy` takes (numpy arrays).  The
    parameters get gradients on; the AdamW step is a 0-d int32 tensor.

    With `mesh` (a (data, model) DeviceMesh of ranks) each rank gets only
    its shards under `training/steps.py:state_specs` (the train rules),
    cut from the numpy arrays, on the rank's device."""
    from .models import Model
    from .models.params import trainable
    from .optim import AdamWState, CompressionState
    from .training.steps import TrainState

    if mesh is None:
        def tree(t):
            return lm_params_from_numpy(cfg, t, device)
    else:
        from .launch.mesh import mesh_device
        from .serving.engine import shard_params
        from .training.steps import state_specs, train_shards

        model = Model(cfg)
        specs = state_specs(model, mesh).params
        shards = train_shards(model, mesh)
        device = mesh_device(mesh)

        def tree(t):
            return shard_params(
                model, lambda d, path: _numpy_leaf(t, path, d.shape),
                shards, specs, device)

    return TrainState(
        params=trainable(tree(params)),
        opt=AdamWState(step=torch.tensor(int(np.asarray(step)),
                                         dtype=torch.int32, device=device),
                       m=tree(m), v=tree(v)),
        compress=None if residual is None else CompressionState(
            residual=tree(residual)))
