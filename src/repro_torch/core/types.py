"""Core datatypes of the MSC (Multi-Slice Clustering) port.

Counterpart of `repro/core/types.py`: the same `MSCConfig` fields and
defaults, and result containers that hold torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MSCConfig:
    """Hyper-parameters of the MSC algorithm (see `repro.core.types`).

    epsilon: similarity threshold ε; Theorem II.1 wants sqrt(ε) ≤ 1/(m−l).
    power_iters: cap on power-iteration sweeps per slice.
    power_tol: λ-weighted Rayleigh-residual tolerance of the convergence
      gate; 0 disables it (fixed trip count).  With the gate on the cap
      rounds up to a multiple of power_check_every.
    power_check_every: sweeps between gate probes (one host sync each).
    precision: "fp32" or "bf16_fp32" (bf16 operands, fp32 accumulation).
    matrix_free: iterate v ← Tᵀ(T v) without forming TᵀT; False forms
      the explicit gram C_i = T_iᵀT_i first (paper Alg. 1).
    epilogue: "allgather" (gather V over the slice ranks) or "ring"
      (p−1 send/receive steps); on one device both are a single
      |V Vᵀ| row-sum.
    max_extraction_iters: cap on the trimming loop (0 → m).
    use_kernels: route the eigensolve (power iteration or gram
      formation) and the flat schedule's epilogue through the CUDA
      kernels (their plain versions on the CPU).
    block_r / block_i / block_j: tile hints of the reference's Pallas
      kernels.  Numerics-neutral; the CUDA kernels size their tiles
      from shared memory and ignore them.
    inner_overlap: on a mesh with an inner dim, the einsum matrix-free
      sweeps split the slices in two halves and overlap one half's
      all_reduce with the other's products (the same bits); no effect
      on one device.
    """

    epsilon: float = 1e-6
    power_iters: int = 60
    power_tol: float = 1e-2
    power_check_every: int = 6
    precision: str = "fp32"
    matrix_free: bool = True
    epilogue: str = "allgather"
    max_extraction_iters: int = 0
    use_kernels: bool = False
    block_r: Optional[int] = None
    block_i: Optional[int] = None
    block_j: Optional[int] = None
    inner_overlap: bool = False

    def with_(self, **kw) -> "MSCConfig":
        return dataclasses.replace(self, **kw)

    def fingerprint(self) -> str:
        """Config digest of the result-cache keys
        (`fingerprint.config_fingerprint`): observational knobs dropped,
        numeric spellings collapsed; equal to the reference's."""
        from .fingerprint import config_fingerprint

        return config_fingerprint(self)


@dataclasses.dataclass
class ModeResult:
    """Result of clustering one tensor mode.

    mask: bool (m,) cluster membership; d: fp32 (m,) marginal sums;
    lambdas: fp32 (m,) top eigenvalues; n_iters: trimming iterations;
    power_iters_run: realized power-iteration sweeps.  The solvers leave
    both counts on the device as 0-d int tensors, as the reference leaves
    jax arrays; a request-batched result (`build_msc_batched`) has a
    leading B dim on every field.  MSCServeEngine returns host results
    with Python ints.
    """

    mask: torch.Tensor
    d: torch.Tensor
    lambdas: torch.Tensor
    n_iters: Union[int, torch.Tensor]
    power_iters_run: Union[int, torch.Tensor, None] = None

    @property
    def indices(self) -> np.ndarray:
        return np.nonzero(self.mask.cpu().numpy())[0]

    @property
    def size(self) -> int:
        return int(self.mask.sum())


@dataclasses.dataclass
class MSCResult:
    """Tricluster: one ModeResult per tensor mode (J1, J2, J3)."""

    modes: tuple

    def __iter__(self):
        return iter(self.modes)

    def __getitem__(self, i):
        return self.modes[i]


@dataclasses.dataclass(frozen=True)
class PlantedSpec:
    """The paper's planted rank-1 model: T = γ·w⊗u⊗v + Z, Z ~ N(0,1)."""

    shape: tuple
    cluster_sizes: tuple
    gamma: float

    @staticmethod
    def paper(m: int, gamma: float) -> "PlantedSpec":
        """Cube tensor with l = 10% of m per mode."""
        l = max(1, (10 * m) // 100)
        return PlantedSpec(shape=(m, m, m), cluster_sizes=(l, l, l),
                           gamma=gamma)


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; raises if `cuda` has no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions")
    return dev
