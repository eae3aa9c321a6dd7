"""MSC-DBSCAN: the multi-cluster extension — counterpart of
`repro/core/dbscan.py`.

The base MSC extracts one cluster per mode.  The DBSCAN extension treats
each slice i as a point whose similarity to slice j is
c_ij = |⟨λ̃_i ṽ_i, λ̃_j ṽ_j⟩| and runs a density-based scan with distance
1 − c_ij, giving several clusters per mode plus noise.  The per-mode
spectral work (V and C) runs on the device through the port's
`normalized_eigrows` and `similarity_matrix`; the scan itself runs on the
host in numpy over the small m × m similarity, as in the reference.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .msc import _on_device, mode_slices, normalized_eigrows, similarity_matrix
from .types import MSCConfig


def dbscan_from_similarity(c: np.ndarray, eps: float,
                           min_samples: int) -> np.ndarray:
    """DBSCAN labels from a similarity matrix (distance = 1 − c).

    Returns int labels (m,): −1 = noise, 0..k−1 = cluster ids.
    """
    c = np.asarray(c)
    m = c.shape[0]
    # neighbourhoods: N(i) = {j : dist(i,j) <= eps}  (includes i itself)
    neigh = (1.0 - c) <= eps
    counts = neigh.sum(axis=1)
    core = counts >= min_samples

    labels = np.full(m, -1, dtype=np.int64)
    cluster = 0
    for i in range(m):
        if labels[i] != -1 or not core[i]:
            continue
        # BFS flood-fill from this core point
        labels[i] = cluster
        frontier = [i]
        while frontier:
            p = frontier.pop()
            if not core[p]:
                continue  # border points do not expand
            for q in np.nonzero(neigh[p])[0]:
                if labels[q] == -1:
                    labels[q] = cluster
                    frontier.append(q)
        cluster += 1
    return labels


def msc_dbscan_mode(tensor, mode: int, cfg: MSCConfig, eps: float = 0.5,
                    min_samples: int = 3, device="cuda"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-cluster MSC for one mode of `tensor` (solved on `device`).
    Returns (labels (m,), C (m, m)) on the host."""
    slices = mode_slices(_on_device(tensor, device), mode)
    v_rows, _, _ = normalized_eigrows(slices, cfg)
    c = similarity_matrix(v_rows, cfg.precision).cpu().numpy()
    return dbscan_from_similarity(c, eps, min_samples), c


def msc_dbscan(tensor, cfg: MSCConfig, eps: float = 0.5,
               min_samples: int = 3, device="cuda") -> List[np.ndarray]:
    """Multi-cluster MSC over all three modes (labels per mode)."""
    t = _on_device(tensor, device)
    return [msc_dbscan_mode(t, j, cfg, eps, min_samples, device=t.device)[0]
            for j in range(3)]
