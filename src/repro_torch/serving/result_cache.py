"""Two-tier content-addressed MSC result cache — counterpart of
`repro/serving/result_cache.py`.

`MSCResultCache` sits in front of `MSCContinuousEngine`:

  * Tier 1, exact hit: key `core.fingerprint.result_cache_key` (tensor
    SHA-256 ⊕ `MSCConfig.fingerprint()` ⊕ code-version salt) → the
    stored per-mode masks, d, λ and sweep counts, answered without
    touching the device.  LRU under `max_bytes`, with the reference's
    byte accounting (each stored leaf's numpy `nbytes`).
  * Tier 2, near hit: an entry may carry the finished solve's iterates
    (one (m, c) matrix per unfolding, read from the slot's frozen carry
    at eviction) and its `spectral_sketch`.  Sketches are bucketed by
    sign-random-projection LSH (`lsh_tables` tables of `lsh_bits` bits,
    the reference's deterministic projections); `lookup_near` probes the
    buckets and accepts the closest candidate of the same shape within
    relative L2 `sketch_tol` (`NearHit`).  The engine seeds a warm
    admission's carry from it through the refill's warm-start inputs.
  * Persistence through `checkpoint/store.py`: `persist()` writes the
    cache as one step (keep-last-1); `MSCResultCache(persist_dir=...)`
    reloads it, dropping entries whose salt is stale.

Entries are kept as numpy arrays, as the reference keeps them; `get`
returns the port's host form (CPU tensors and Python ints).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fingerprint import cache_salt, host_array
from repro_torch.core.types import ModeResult, MSCResult


def _count(x) -> np.ndarray:
    """A sweep or trim count as a numpy array: a Python int (the port's
    host results) as int32, the dtype of the reference engine's counts."""
    if isinstance(x, (int, np.integer)) and not isinstance(x, np.ndarray):
        return np.asarray(x, np.int32 if isinstance(x, int) else x.dtype)
    return host_array(x)


def _np_result(result: MSCResult) -> MSCResult:
    """Host numpy copy of an MSCResult."""
    modes = []
    for res in result.modes:
        pir = res.power_iters_run
        modes.append(ModeResult(
            mask=host_array(res.mask).copy(), d=host_array(res.d).copy(),
            lambdas=host_array(res.lambdas).copy(),
            n_iters=_count(res.n_iters),
            power_iters_run=None if pir is None else _count(pir)))
    return MSCResult(modes=tuple(modes))


def _port_result(result: MSCResult) -> MSCResult:
    """A stored entry in the port's host form: new CPU tensors, ints."""
    return MSCResult(modes=tuple(
        ModeResult(mask=torch.tensor(res.mask), d=torch.tensor(res.d),
                   lambdas=torch.tensor(res.lambdas),
                   n_iters=int(res.n_iters),
                   power_iters_run=None if res.power_iters_run is None
                   else int(res.power_iters_run))
        for res in result.modes))


@dataclasses.dataclass
class _CacheEntry:
    key: str
    shape: Tuple[int, int, int]
    result: MSCResult                      # host numpy, true sizes
    vectors: Optional[Tuple[np.ndarray, ...]] = None  # (m_j, c_j) per mode
    sketch: Optional[np.ndarray] = None
    lsh_keys: Tuple = ()

    @property
    def nbytes(self) -> int:
        n = 0
        for res in self.result.modes:
            for leaf in (res.mask, res.d, res.lambdas, res.n_iters,
                         res.power_iters_run):
                if leaf is not None:
                    n += np.asarray(leaf).nbytes
        for v in self.vectors or ():
            n += v.nbytes
        if self.sketch is not None:
            n += self.sketch.nbytes
        return n

    @property
    def donor_iters(self) -> Tuple[int, int, int]:
        """The cached solve's sweeps per mode: what `warm_sweeps_saved`
        compares a warm start against."""
        return tuple(
            0 if res.power_iters_run is None else int(res.power_iters_run)
            for res in self.result.modes)


@dataclasses.dataclass(frozen=True)
class NearHit:
    """A tier-2 match: the cached iterates to seed the admitted slot
    with, the donor's sweeps and the verified distance."""
    key: str
    vectors: Tuple[np.ndarray, ...]
    donor_iters: Tuple[int, int, int]
    distance: float


class MSCResultCache:
    """LRU, size-bounded, optionally persistent MSC result cache.

    max_bytes: payload budget; an insert past it evicts the least
      recently used entries (the newest entry is always admitted).
    persist_dir: persistence through `checkpoint/store.py`; the
      constructor reloads the newest restorable step.
    sketch_r: probes per unfolding of the tier-2 sketch.
    sketch_tol: relative L2 bound of a near hit.
    lsh_bits / lsh_tables: the LSH geometry (a match in any table makes
      a candidate).
    """

    def __init__(self, max_bytes: int = 256 << 20,
                 persist_dir: Optional[str] = None, *,
                 sketch_r: int = 4, sketch_tol: float = 0.05,
                 lsh_bits: int = 8, lsh_tables: int = 4):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self.persist_dir = persist_dir
        self.sketch_r = int(sketch_r)
        self.sketch_tol = float(sketch_tol)
        self.lsh_bits = int(lsh_bits)
        self.lsh_tables = int(lsh_tables)
        self.salt = cache_salt()
        self._entries: "OrderedDict[str, _CacheEntry]" = OrderedDict()
        self._nbytes = 0
        self._buckets: Dict[Tuple, List[str]] = {}
        self._proj: Dict[Tuple[int, int], np.ndarray] = {}
        self._persist_step = 0
        self.hits = self.misses = self.near_hits = self.evicted = 0
        if persist_dir is not None:
            self._load(persist_dir)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    @property
    def nbytes(self) -> int:
        return self._nbytes

    # ---- tier 1: exact ------------------------------------------------
    def get(self, key: str) -> Optional[MSCResult]:
        """Exact lookup; a hit refreshes its recency and comes back in the
        port's host form."""
        e = self._entries.get(key)
        if e is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return _port_result(e.result)

    def put(self, key: str, result: MSCResult, *, shape,
            vectors: Optional[Tuple[np.ndarray, ...]] = None,
            sketch: Optional[np.ndarray] = None) -> None:
        """Insert (or refresh) one finished solve; without vectors and a
        sketch the entry serves exact hits only."""
        if key in self._entries:
            self._remove(key)
        entry = _CacheEntry(
            key=key, shape=tuple(int(s) for s in shape),
            result=_np_result(result),
            vectors=None if vectors is None else tuple(
                np.ascontiguousarray(host_array(v, np.float32))
                for v in vectors),
            sketch=None if sketch is None else
            np.ascontiguousarray(sketch, np.float32))
        if entry.vectors is not None and entry.sketch is not None:
            entry.lsh_keys = self._bucket_keys(entry.sketch, entry.shape)
            for bk in entry.lsh_keys:
                self._buckets.setdefault(bk, []).append(key)
        self._entries[key] = entry
        self._nbytes += entry.nbytes
        while self._nbytes > self.max_bytes and len(self._entries) > 1:
            self._remove(next(iter(self._entries)))
            self.evicted += 1

    def _remove(self, key: str) -> None:
        e = self._entries.pop(key)
        self._nbytes -= e.nbytes
        for bk in e.lsh_keys:
            keys = self._buckets.get(bk)
            if keys is not None:
                if key in keys:
                    keys.remove(key)
                if not keys:
                    del self._buckets[bk]

    # ---- tier 2: near hit -------------------------------------------
    def _projection(self, table: int, dim: int) -> np.ndarray:
        pk = (table, dim)
        proj = self._proj.get(pk)
        if proj is None:
            # deterministic per (table, sketch length): every host and
            # both packages bucket a sketch alike
            rng = np.random.RandomState(10007 * (table + 1) + dim)
            proj = rng.standard_normal((self.lsh_bits, dim)) \
                      .astype(np.float32)
            self._proj[pk] = proj
        return proj

    def _bucket_keys(self, sketch: np.ndarray, shape) -> Tuple:
        s = np.asarray(sketch, np.float32).reshape(-1)
        nrm = float(np.linalg.norm(s))
        s_hat = s / nrm if nrm > 0 else s
        keys = []
        for t in range(self.lsh_tables):
            bits = self._projection(t, s.size) @ s_hat >= 0.0
            code = int.from_bytes(
                np.packbits(bits, bitorder="little").tobytes(), "little")
            keys.append((tuple(shape), t, code))
        return tuple(keys)

    def lookup_near(self, sketch: np.ndarray, shape) -> Optional[NearHit]:
        """The closest cached entry of the same shape within `sketch_tol`
        among the sketch's LSH candidates, or None."""
        shape = tuple(int(x) for x in shape)
        s = np.asarray(sketch, np.float32).reshape(-1)
        cand: List[str] = []
        for bk in self._bucket_keys(s, shape):
            cand.extend(self._buckets.get(bk, ()))
        best: Optional[NearHit] = None
        for key in dict.fromkeys(cand):       # dedupe, keep order
            e = self._entries.get(key)
            if e is None or e.sketch is None or e.vectors is None:
                continue
            if e.shape != shape or e.sketch.size != s.size:
                continue
            ref = float(np.linalg.norm(e.sketch))
            dist = float(np.linalg.norm(s - e.sketch)) / max(ref, 1e-30)
            if dist <= self.sketch_tol and (best is None
                                            or dist < best.distance):
                best = NearHit(key=key, vectors=e.vectors,
                               donor_iters=e.donor_iters, distance=dist)
        if best is not None:
            self._entries.move_to_end(best.key)
            self.near_hits += 1
        return best

    # ---- persistence ------------------------------------------------
    def persist(self) -> Optional[str]:
        """Write the cache as one atomic checkpoint step (LRU order kept),
        keep-last-1.  A no-op without persist_dir."""
        if self.persist_dir is None:
            return None
        from repro_torch.checkpoint.store import (gc_checkpoints,
                                                  save_checkpoint)

        leaves: List[np.ndarray] = []
        metas = []
        for e in self._entries.values():
            for res in e.result.modes:
                pir = (-1 if res.power_iters_run is None
                       else int(res.power_iters_run))
                leaves.extend([np.asarray(res.mask), np.asarray(res.d),
                               np.asarray(res.lambdas),
                               np.asarray(res.n_iters, np.int64),
                               np.asarray(pir, np.int64)])
            if e.vectors is not None:
                leaves.extend(e.vectors)
            if e.sketch is not None:
                leaves.append(e.sketch)
            metas.append({"key": e.key, "shape": list(e.shape),
                          "has_vectors": e.vectors is not None,
                          "has_sketch": e.sketch is not None})
        self._persist_step += 1
        path = save_checkpoint(self.persist_dir, self._persist_step, leaves,
                               extra={"kind": "msc_result_cache",
                                      "salt": self.salt,
                                      "entries": metas})
        gc_checkpoints(self.persist_dir, 1)
        return path

    def _load(self, directory: str) -> None:
        from repro_torch.checkpoint.store import (load_leaves,
                                                  restorable_steps)

        steps = restorable_steps(directory, verify_sha=False)
        if not steps:
            return
        try:
            leaves, extra = load_leaves(directory, steps[0], verify=True)
        except (IOError, OSError, ValueError):
            return
        if extra.get("kind") != "msc_result_cache":
            return
        stale = extra.get("salt") != self.salt
        self._persist_step = steps[0]
        it = iter(leaves)
        for meta in extra.get("entries", ()):
            modes = []
            for _ in range(3):
                mask, d, lam, n_it, pir = (next(it) for _ in range(5))
                modes.append(ModeResult(
                    mask=mask, d=d, lambdas=lam, n_iters=n_it,
                    power_iters_run=None if int(pir) < 0 else pir))
            vectors = (tuple(next(it) for _ in range(3))
                       if meta["has_vectors"] else None)
            sketch = next(it) if meta["has_sketch"] else None
            if stale:
                continue  # drain the iterator, drop stale-salt entries
            self.put(meta["key"], MSCResult(modes=tuple(modes)),
                     shape=meta["shape"], vectors=vectors, sketch=sketch)
