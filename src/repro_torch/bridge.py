"""State carried across from the JAX reference to the port.

MSC has no weights: what carries over is the configuration, the input
tensor and the eigensolver's carry.  Everything crosses as plain Python
values or numpy arrays, so this module needs neither package's internals.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.power_iter import SolveState
from .core.types import MSCConfig


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
