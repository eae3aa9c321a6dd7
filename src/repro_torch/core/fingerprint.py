"""Content-addressed fingerprints of the MSC result cache — counterpart
of `repro/core/fingerprint.py`.

MSC is deterministic: the same tensor bytes under the same solver
configuration give the same masks.  So (tensor content, solver config,
code version) is a sound cache key, built from:

  * `tensor_fingerprint` — SHA-256 over the C-contiguous bytes and a
    shape/dtype header, taken on the numpy side: invariant to memory
    layout, sensitive to every element.  A torch tensor is read to the
    host first (on a card, a device-to-host copy per key).  For the same
    host bytes the digest equals the reference's.
  * `config_fingerprint` — sorted-field digest of an `MSCConfig` (or a
    dict of knobs) with the observational knobs dropped and numeric
    spellings collapsed (60 == 60.0): the reference's digest.
  * `cache_salt` — the code-version salt; it mixes in `torch.__version__`
    where the reference mixes in jax's, so a cache the reference
    persisted misses here by design.
  * `spectral_sketch` — the tier-2 near-hit signature: per slice of each
    unfolding, ‖T_i u_k‖² against fixed unit probes (the solver's start
    vector and harmonics), on the host in numpy.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Iterable, Union

import numpy as np

from .msc import MODE_PERMS

# bump on any change that alters solver numerics or result layout: a
# persisted cache written by older code then misses
CODE_VERSION = "msc-result-cache-v1"

# engine and scheduler knobs that never change what a solve returns;
# dropped from config digests so that policy tuning never fragments the
# cache (the reference's set)
OBSERVATIONAL_KNOBS = frozenset({
    "ckpt_every_chunks", "keep_checkpoints", "checkpoint_dir",
    "max_retries", "retry_backoff_s", "retry_backoff_max_s",
    "refill_min_free", "max_queue_chunks", "placement",
    "chunks_per_step", "bucket_quantum", "slots",
    "block_r", "block_i", "block_j", "inner_overlap",
})


def host_array(x, dtype=None) -> np.ndarray:
    """x as a numpy array on the host (a torch tensor is copied there
    first), cast to `dtype` when given."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def tensor_fingerprint(arr) -> str:
    """SHA-256 of a tensor's canonical (C-contiguous) bytes and header:
    the same values in any memory layout hash alike; a reshape or a cast
    is another key."""
    a = np.ascontiguousarray(host_array(arr))
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(np.asarray(a.shape, np.int64).tobytes())
    h.update(a.tobytes())
    return h.hexdigest()


def _canon_value(v):
    """Canonical token of one knob value: numbers collapse to float (60
    and 60.0 are one setting), bools stay apart from ints."""
    if isinstance(v, bool):
        return f"b:{int(v)}"
    if isinstance(v, (int, float, np.integer, np.floating)):
        return f"n:{float(v)!r}"
    if v is None:
        return "z"
    return f"s:{v}"


def config_fingerprint(cfg: Union[dict, object],
                       ignore: Iterable[str] = OBSERVATIONAL_KNOBS) -> str:
    """Sorted-field digest of a solver config (a dataclass or a dict),
    without the `ignore` knobs."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        d = dataclasses.asdict(cfg)
    elif isinstance(cfg, dict):
        d = dict(cfg)
    else:
        raise TypeError(f"expected a dataclass or dict, got {type(cfg)}")
    drop = set(ignore)
    items = sorted((k, _canon_value(v)) for k, v in d.items()
                   if k not in drop)
    return hashlib.sha256(json.dumps(items).encode()).hexdigest()


def cache_salt() -> str:
    """Code-version salt of every tier-1 key: the repo's numerics version
    and the torch runtime a persisted cache was written under."""
    import torch

    return hashlib.sha256(
        f"{CODE_VERSION}|torch={torch.__version__}".encode()).hexdigest()[:16]


def result_cache_key(arr, cfg, salt: str = None) -> str:
    """The tier-1 key: tensor content ⊕ solver config ⊕ code salt."""
    return "-".join((tensor_fingerprint(arr), config_fingerprint(cfg),
                     salt if salt is not None else cache_salt()))


def _probe_vectors(c: int, r: int) -> np.ndarray:
    """(r, c) fixed unit probes: row 0 the eigensolver's start direction,
    the rest harmonics (no PRNG: the same on every host)."""
    i = np.arange(c, dtype=np.float32)
    rows = [np.ones(c, np.float32) + 0.01 * np.sin(1.37 * i + 0.3)]
    for k in range(1, r):
        rows.append(np.cos((k + 0.731) * i + 0.17 * k).astype(np.float32))
    p = np.stack(rows[:r])
    return p / np.linalg.norm(p, axis=1, keepdims=True)


def spectral_sketch(arr, r: int = 4) -> np.ndarray:
    """Tier-2 near-hit signature: ‖T_i u_k‖² for the r probes u_k, per
    slice i of each unfolding, concatenated (the reference's sketch).
    Small perturbations move every entry by O(‖δ‖)."""
    a = np.ascontiguousarray(host_array(arr, np.float32))
    if a.ndim != 3:
        raise ValueError(f"spectral_sketch needs a 3rd-order tensor, "
                         f"got shape {a.shape}")
    sigs = []
    for perm in MODE_PERMS:
        t = np.transpose(a, perm)                       # (m, rows, c)
        probes = _probe_vectors(t.shape[-1], r)         # (r, c)
        tu = np.einsum("mrc,kc->mrk", t, probes)
        sigs.append(np.sum(tu * tu, axis=1).reshape(-1))  # (m·r,)
    return np.concatenate(sigs)
