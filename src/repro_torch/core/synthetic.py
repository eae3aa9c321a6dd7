"""Synthetic planted-tricluster tensors (paper §IV experimental model).

T = γ · w ⊗ u ⊗ v + Z with unit-norm indicator factors on the planted
index sets and Z_ijk ~ N(0, 1).  Noise comes from an explicit
`torch.Generator`, so a tensor is reproducible from its seed but is not
bit-equal to the reference's threefry draw: parity tests build their
inputs with numpy or the reference and never with this module.  The
signal part and the chunk bounds are the reference's.
"""
from __future__ import annotations

import torch

from .types import PlantedSpec


def _index_sets(spec: PlantedSpec, index_sets, device):
    if index_sets is None:
        return [torch.arange(spec.cluster_sizes[k], device=device)
                for k in range(3)]
    return [torch.as_tensor(ix, device=device).long() for ix in index_sets]


def planted_factors(spec: PlantedSpec, index_sets=None, device="cpu"):
    """The three factor vectors (w: mode-1, u: mode-2, v: mode-3)."""
    factors = []
    for k, idx in enumerate(_index_sets(spec, index_sets, device)):
        f = torch.zeros(spec.shape[k], dtype=torch.float32, device=device)
        f[idx] = 1.0 / float(idx.numel()) ** 0.5
        factors.append(f)
    return tuple(factors)


def planted_masks(spec: PlantedSpec, index_sets=None, device="cpu"):
    """Boolean membership masks per mode (ground truth for metrics)."""
    masks = []
    for k, idx in enumerate(_index_sets(spec, index_sets, device)):
        mk = torch.zeros(spec.shape[k], dtype=torch.bool, device=device)
        mk[idx] = True
        masks.append(mk)
    return tuple(masks)


def make_planted_tensor(generator: torch.Generator, spec: PlantedSpec,
                        index_sets=None, dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """Sample T = γ·w⊗u⊗v + Z on the generator's device.

    The signal is added in place on the planted block only, so the peak
    memory is the tensor itself (4 GB at m = 1000 in fp32).
    """
    device = generator.device if device is None else torch.device(device)
    t = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    w, u, v = planted_factors(spec, index_sets, device)
    i0, i1, i2 = _index_sets(spec, index_sets, device)
    t[i0[:, None, None], i1[None, :, None], i2[None, None, :]] += (
        spec.gamma * w[i0][:, None, None] * u[i1][None, :, None]
        * v[i2][None, None, :])
    return t.to(dtype)


def make_planted_tensor_chunked(generator: torch.Generator, spec: PlantedSpec,
                                n_chunks: int, index_sets=None):
    """Generator of mode-1 slabs of the planted tensor, on the generator's
    device.

    The paper's remark that data is "distributed or produced on the
    processes themselves": each chunk (a block of mode-1 slices) can be
    produced by its owner without materializing T.  Yields
    (start_index, slab) pairs, slab (hi − lo, m2, m3) fp32, with the
    reference's bounds round(i·m1/n_chunks) (empty chunks skipped) and its
    signal γ·w[lo:hi]⊗u⊗v.  The noise of chunk c is the generator's next
    (hi − lo, m2, m3) normal draw, so the slabs equal the reference's in
    their signal only.
    """
    device = generator.device
    m1, m2, m3 = spec.shape
    w, u, v = planted_factors(spec, index_sets, device)
    bounds = [int(round(i * m1 / n_chunks)) for i in range(n_chunks + 1)]
    for c in range(n_chunks):
        lo, hi = bounds[c], bounds[c + 1]
        if hi == lo:
            continue
        sig = spec.gamma * torch.einsum("i,j,k->ijk", w[lo:hi], u, v)
        yield lo, sig + torch.randn((hi - lo, m2, m3), generator=generator,
                                    dtype=torch.float32, device=device)
