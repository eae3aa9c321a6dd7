"""The benchmark's inputs, made on the device from the run's seed.

The paper's planted model (arXiv:2309.17383, §IV): T = γ·w⊗u⊗v + Z with
Z_ijk ~ N(0, 1) and unit-norm indicator factors w, u, v on the first l
indices of each mode.  A pool of n cubes is drawn in one call of a
`torch.Generator` on the device, so the same seed gives the same tensors
on every card, and the signal is added to each cube's planted block.
Which cube of the pool a request sends is drawn from the seed too
(`order`); the pool's make-up (sizes and γ's) and the pattern of slow
and fast arrivals do not depend on it.  Where the sweeps a tensor needs
would make the seed change the work, the mix fixes the spectra and the
seed permutes the tensors (`planted_pool`).
"""
from __future__ import annotations

import numpy as np
import torch


def child_seed(seed: int, *path: int) -> int:
    """A 64-bit seed for one stream of the run (the pool's noise, the
    request order), derived from the run's seed."""
    return int(np.random.SeedSequence([seed % 2**64, *path])
               .generate_state(1, np.uint64)[0])


def gammas(traffic: dict, n: int) -> list:
    """γ of each pool entry: `gamma_slow` for every `slow_every`-th entry
    (from entry 0), `gamma` for the rest."""
    every = traffic.get("slow_every", 0)
    return [traffic["gamma_slow"] if every and i % every == 0
            else traffic["gamma"] for i in range(n)]


def planted_pool(seed: int, traffic: dict, m: int, l: int,
                 device) -> torch.Tensor:
    """(n, m, m, m) fp32: cube i is γ_i·w⊗u⊗v plus unit normal noise,
    the factors 1/sqrt(l) on indices 0…l−1 of each mode.

    With the mix's "spectra": "fixed", the noise comes from one stream
    for every seed, and the run's seed draws, for each cube, a
    permutation and signs of its mode-1 indices instead.  Those leave
    every slice covariance of every mode as it was (mode 1's slices are
    relabelled, modes 2 and 3 see their rows reordered and negated), and
    the eigensolver's start vectors do not depend on the slice order, so
    the gate runs the same sweeps for every seed while the tensors'
    layout, signs and planted index set differ."""
    gammas_ = gammas(traffic, traffic["pool"])
    fixed = traffic.get("spectra") == "fixed"
    gen = torch.Generator(device=device).manual_seed(
        child_seed(0 if fixed else seed, 0))
    pool = torch.randn((len(gammas_), m, m, m), generator=gen,
                       dtype=torch.float32, device=device)
    # γ·w_i·u_j·v_k = γ / l^{3/2} on the planted block
    for i, (cube, g) in enumerate(zip(pool, gammas_)):
        cube[:l, :l, :l] += float(g) / float(l) ** 1.5
        if fixed:
            gen = torch.Generator(device=device).manual_seed(
                child_seed(seed, 2, i))
            perm = torch.randperm(m, generator=gen, device=device)
            sign = torch.randint(0, 2, (m, 1, 1), generator=gen,
                                 device=device) * 2.0 - 1.0
            cube.copy_(cube[perm] * sign)
    return pool


def order(seed: int, traffic: dict, count: int) -> np.ndarray:
    """`count` pool indices in the order the clients send them.

    Without `slow_every`: shuffled passes over the pool, so every entry is
    sent equally often.  With it, position p sends a slow entry when
    p % slow_every == 0 and a fast one otherwise, each class in shuffled
    passes of its own: the arrival pattern of slow and fast requests is
    the same for every seed, and only which tensor of a class comes next
    depends on it."""
    rng = np.random.default_rng(child_seed(seed, 1))
    n, every = traffic["pool"], traffic.get("slow_every", 0)
    if not every:
        return _passes(rng, np.arange(n), count)
    slow = np.arange(0, n, every)
    fast = np.setdiff1d(np.arange(n), slow)
    is_slow = np.arange(count) % every == 0
    n_slow = int(is_slow.sum())
    out = np.empty(count, np.int64)
    out[is_slow] = _passes(rng, slow, n_slow)
    out[~is_slow] = _passes(rng, fast, count - n_slow)
    return out


def _passes(rng, ids: np.ndarray, count: int) -> np.ndarray:
    reps = -(-count // len(ids))
    return rng.permuted(np.tile(ids, (reps, 1)), axis=1).ravel()[:count]
