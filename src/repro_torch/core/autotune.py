"""The continuous engine's autotuner, with a content-addressed persisted
cache — counterpart of `repro/core/autotune.py`.

The reference searches the block shapes of its Pallas kernels.  Those
knobs mean nothing to the port's kernels (`MSCConfig.block_r/i/j` are
inert: the CUDA kernels size their own tiles), so the port searches what
does change how its chunk step runs: the route of the power kernel
(`kernels/power_iter.py:routes`), per mode, beside the epilogue and
`inner_overlap` proposals of the roofline models that the engine adds.

  * `route_candidates` — the port's per-bucket search space: one
    candidate per route the power kernel takes for the bucket's slice
    shapes and passes over T a launch, the current pick
    (`power_iter.route`) first.  Each candidate
    also carries the reference's default blocks, so an entry has the
    reference's keys.  On the CPU, and without kernels, one candidate.
  * `block_candidates` — the reference's block search space, kept as it
    is (the engine does not search it).
  * `search_blocks` — measure-and-pick, default first: the default wins
    within `margin` of the fastest, so jittery timings do not flap a
    retune.  A candidate's payload (its captured graphs) is dropped as
    soon as it can no longer win, so at most two candidates' graphs are
    held while the next one is captured.
  * `AutotuneCache` — winners keyed by (bucket and slots, mesh, dtype,
    `config_fingerprint` of the resolved config, `cache_salt`), persisted
    through `checkpoint/store.py` (format 1, keep-last-1, stale salts
    dropped at load, `gc_checkpoints` reaping an `autotune/`
    subdirectory of an engine's checkpoint directory).
"""
from __future__ import annotations

import json
from typing import Callable, Dict, Iterable, List, Optional, Tuple

AUTOTUNE_KIND = "msc_autotune_cache"

# the reference's hand-set Pallas block defaults (inert in the port)
DEFAULT_BLOCKS: Dict[str, int] = {"block_r": 256, "block_i": 128,
                                  "block_j": 128}
# prefer the default on near-ties: timing jitter must not flap retunes
DEFAULT_MARGIN = 0.05
# the wider margin when a roofline proposal (epilogue / inner_overlap)
# is validated: a proposal must beat the default decisively
VALIDATE_MARGIN = 0.10


def autotune_key(shape_sig, mesh_shape, dtype, cfg, salt: Optional[str]
                 = None) -> str:
    """Content-addressed key of one autotune problem: the shape signature
    (the engine passes (bucket..., slots)), the mesh's (dim, size) items,
    the dtype, `config_fingerprint(cfg)` (block knobs dropped; a string
    passes as is) and the salt (`fingerprint.cache_salt()` by default).
    Equal to the reference's for equal arguments."""
    from .fingerprint import cache_salt, config_fingerprint

    return "|".join((
        "x".join(str(int(s)) for s in shape_sig),
        ",".join(f"{a}={n}" for a, n in mesh_shape),
        str(dtype),
        config_fingerprint(cfg) if not isinstance(cfg, str) else cfg,
        salt if salt is not None else cache_salt(),
    ))


def block_candidates(bucket, use_kernels: bool) -> List[Dict[str, int]]:
    """The reference's block search space: the defaults, then r-tile and
    epilogue-tile variants, clamped to the bucket's largest dim and
    deduplicated; one candidate without kernels."""
    if not use_kernels:
        return [dict(DEFAULT_BLOCKS)]
    m = max(int(s) for s in bucket) if bucket else 1
    raw: List[Dict[str, int]] = [dict(DEFAULT_BLOCKS)]
    for br in (128, 512):
        raw.append({"block_r": br, "block_i": 128, "block_j": 128})
    for bij in (64, 256):
        raw.append({"block_r": 256, "block_i": bij, "block_j": bij})
    out, seen = [], set()
    for cand in raw:
        eff = (min(cand["block_r"], m), min(cand["block_i"], m),
               min(cand["block_j"], m))
        if eff in seen:
            continue
        seen.add(eff)
        out.append(cand)
    return out


def route_candidates(bucket, dtype, use_kernels: bool,
                     passes: int = 1) -> List[Dict]:
    """The port's per-bucket search space: the power kernel's routes.

    Mode j of a bucket (M1, M2, M3) has slices of r_j = (M2, M1, M1)[j]
    rows of c_j = (M3, M3, M2)[j] elements in the precision policy's
    `dtype`, and each launch passes over them `passes` times (the gate
    chunk's sweeps; 1 where each sweep is its own `power_matvec`).  The
    first candidate is the current pick, `power_iter.route(c_j, dtype,
    passes, r_j)` per mode; then, per route the kernel takes for some mode
    ("general", "ring", "direct", "resident"), that route on every mode
    that takes it (the pick on the others), deduplicated.  Without kernels
    on a card (`use_kernels` False: no kernel, or the CPU's plain
    versions) one candidate, `power_route` None: the resolution still
    runs, as the reference's einsum path's.  Each candidate carries
    `DEFAULT_BLOCKS` besides `power_route`.

    Bits: each route sums in its own order, so the routes need not agree
    bit for bit with each other (within one route two calls give the same
    bits).  On an H100 at m = 200 fp32 the two streaming routes ("direct",
    "ring") give the same bits and "general" differs in the last bits (d
    and λ within ~1e-5 relative), masks and sweeps equal on all three
    (`chip_smoke.py` phase 14; PERF.md).
    """
    if not use_kernels:
        return [dict(DEFAULT_BLOCKS, power_route=None)]
    from repro_torch.kernels import power_iter

    cols = (int(bucket[2]), int(bucket[2]), int(bucket[1]))
    rows = (int(bucket[1]), int(bucket[0]), int(bucket[0]))
    pick = tuple(power_iter.route(c, dtype, passes, r)
                 for c, r in zip(cols, rows))
    out, seen = [dict(DEFAULT_BLOCKS, power_route=pick)], {pick}
    for name in ("general", "ring", "direct", "resident"):
        cand = tuple(name if name in power_iter.routes(c, dtype, passes)
                     else p for c, p in zip(cols, pick))
        if cand not in seen:
            seen.add(cand)
            out.append(dict(DEFAULT_BLOCKS, power_route=cand))
    return out


def _winner(secs: List[float], margin: float) -> int:
    """The reference's pick: the fastest, unless the default (index 0) is
    within `margin` of it."""
    best = min(range(len(secs)), key=secs.__getitem__)
    if best != 0 and secs[0] <= secs[best] * (1.0 + margin):
        best = 0
    return best


def _beaten(secs: List[float], margin: float) -> List[int]:
    """Indices measured so far that cannot be `_winner` whatever the
    candidates still to come measure: a non-default slower than another
    (or tied with an earlier one), the default once another beats it by
    more than `margin`."""
    out = []
    for i, t in enumerate(secs):
        if i == 0:
            lost = any(t > u * (1.0 + margin) for u in secs[1:])
        else:
            lost = any(u < t or (u == t and j < i)
                       for j, u in enumerate(secs) if j != i)
        if lost:
            out.append(i)
    return out


def search_blocks(candidates: Iterable[Dict],
                  measure: Callable[[Dict], Tuple[float, object]],
                  *, margin: float = DEFAULT_MARGIN):
    """Measure every candidate and pick the winner.

    measure(candidate) -> (seconds, payload): build the candidate and
    time it; the payload (its captured programs) comes back for the
    winner, so the winning candidate is never built twice.  The first
    candidate is the default and wins within `margin` of the fastest.
    The search drops each payload as soon as it cannot win.

    Returns (winner_candidate, winner_payload, timings), timings a
    {json-candidate: seconds} dict (persisted for observability).
    """
    cands = list(candidates)
    if not cands:
        raise ValueError("no autotune candidates")
    timings: Dict[str, float] = {}
    secs_of: List[float] = []
    payloads: List[object] = []
    for cand in cands:
        secs, payload = measure(cand)
        timings[json.dumps(cand, sort_keys=True)] = float(secs)
        secs_of.append(float(secs))
        payloads.append(payload)
        for i in _beaten(secs_of, margin):
            payloads[i] = None
    best = _winner(secs_of, margin)
    return cands[best], payloads[best], timings


class AutotuneCache:
    """Persisted content-addressed store of autotune winners.

    key → entry (the winning candidate's knobs, "searched", "timings"),
    persisted through `checkpoint/store.py` as one step with no array
    leaves (the entries ride the manifest's `extra`) under `persist_dir`,
    keep-last-1.  The salt rides the manifest: a reload under another
    salt drops every entry, so a code or torch bump re-searches.

    Counters: `searches` (misses that ran a live search) and `hits`
    (resolutions served from the cache), which the engine reports as
    `ServeStats.autotune_searches` / `autotune_cache_hits`.
    """

    def __init__(self, persist_dir: Optional[str] = None,
                 salt: Optional[str] = None):
        from .fingerprint import cache_salt

        self.salt = salt if salt is not None else cache_salt()
        self.persist_dir = persist_dir
        self._entries: Dict[str, Dict] = {}
        self._persist_step = 0
        self.searches = 0
        self.hits = 0
        if persist_dir:
            self._load(persist_dir)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def entries(self) -> Dict[str, Dict]:
        return dict(self._entries)

    def get(self, key: str) -> Optional[Dict]:
        e = self._entries.get(key)
        if e is not None:
            self.hits += 1
        return e

    def put(self, key: str, entry: Dict):
        self._entries[key] = dict(entry)

    def resolve(self, key: str, candidates: Iterable[Dict], measure, *,
                margin: float = DEFAULT_MARGIN):
        """Get-or-search: the cached winner (payload None: the caller
        builds it) or a live `search_blocks` whose winner is recorded.
        Returns (knobs dict, payload), the knobs the winning candidate
        verbatim."""
        e = self.get(key)
        if e is not None:
            return ({k: v for k, v in e.items()
                     if k not in ("searched", "timings")}, None)
        self.searches += 1
        winner, payload, timings = search_blocks(candidates, measure,
                                                 margin=margin)
        entry = dict(winner)
        entry["searched"] = len(timings) > 1
        entry["timings"] = timings
        self.put(key, entry)
        return (dict(winner), payload)

    # ---- persistence (as serving/result_cache.py) ----------------------
    def persist(self) -> Optional[str]:
        """Write every entry as one checkpoint step (atomic), keep 1."""
        if not self.persist_dir:
            return None
        from repro_torch.checkpoint.store import (gc_checkpoints,
                                                  save_checkpoint)

        self._persist_step += 1
        path = save_checkpoint(
            self.persist_dir, self._persist_step, [],
            extra={"kind": AUTOTUNE_KIND, "salt": self.salt,
                   "entries": self._entries})
        gc_checkpoints(self.persist_dir, 1)
        return path

    def _load(self, directory: str):
        from repro_torch.checkpoint.store import (load_leaves,
                                                  restorable_steps)

        steps = restorable_steps(directory, verify_sha=False)
        if not steps:
            return
        try:
            _, extra = load_leaves(directory, steps[0], verify=True)
        except (IOError, OSError, ValueError):
            return
        if extra.get("kind") != AUTOTUNE_KIND:
            return
        self._persist_step = steps[0]
        if extra.get("salt") != self.salt:
            return  # stale salt: drop every persisted winner
        for key, entry in dict(extra.get("entries", {})).items():
            if all(k in entry for k in DEFAULT_BLOCKS):
                self._entries[key] = dict(entry)
