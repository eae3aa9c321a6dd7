"""Checkpoint store, format 1 — counterpart of `repro/checkpoint/store.py`.

Layout: <dir>/step_<k>/ {manifest.json, leaf_<i>.npy…}.  Leaves are
numpy arrays in `.npy` files and the manifest is JSON, as the
reference writes them, so each package reads the other's checkpoints.

  * Atomic commit: every leaf is written to a `.tmp` sibling and
    `os.replace`d into place, and the step directory is written as
    step_<k>.tmp and renamed last, so a crashed writer never leaves a
    half step that a restore would pick up.  Only the manifest (the
    commit record) fsyncs; the step directory and its parent fsync after
    the rename (`fsync_dir`).
  * Integrity: a SHA-256 per leaf in the manifest, checked on restore;
    `restorable_steps` skips a corrupt step with a warning, so a restore
    falls back to the previous step.
  * Self-describing: `load_leaves` rebuilds the flat leaf list from the
    manifest alone (shapes and dtypes are in the .npy headers).
  * Keep-last-k GC, which also reaps `.tmp` step directories and shard
    files no manifest references.

Not here: the multi-process format 2 (`begin_sharded_checkpoint`,
`write_process_shards`, `commit_sharded_checkpoint`, and reading its
shard files) belongs to the multi-host control plane,
`launch/distributed.py` (ROADMAP.md queue 1 item 10b); a
format-2 step fails validation here and is skipped.  `CheckpointManager`
and `restore_checkpoint`, used only by training, are item 12.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.fingerprint import host_array


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def fsync_dir(path: str) -> None:
    """fsync a directory, so that an entry just renamed into it survives
    a power loss."""
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_atomic(path: str, writer, fsync: bool = True) -> None:
    """Write a file through a `.tmp` sibling and os.replace; fsync=False
    skips the file's fsync (leaves: a torn leaf fails its SHA check on
    restore instead)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        writer(f)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)


def save_checkpoint(directory: str, step: int, leaves: Sequence,
                    extra: Optional[Dict] = None) -> str:
    """Atomic checkpoint of a flat list of leaves (numpy arrays, torch
    tensors or scalars, each written as a .npy), with `extra` JSON
    metadata in the manifest.  Returns the step directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = list(leaves)
    manifest = {
        "step": step,
        # the reference's treedef string of a flat list
        "treedef": f"PyTreeDef([{', '.join('*' * len(leaves))}])",
        "extra": extra or {},
        "leaves": [],
    }
    for i, leaf in enumerate(leaves):
        arr = host_array(leaf)
        path = os.path.join(tmp, f"leaf_{i:05d}.npy")
        _write_atomic(path, lambda f, a=arr: np.save(f, a), fsync=False)
        manifest["leaves"].append({
            "i": i, "shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": _sha(arr),
        })
    _write_atomic(os.path.join(tmp, "manifest.json"),
                  lambda f: f.write(json.dumps(manifest).encode()))
    fsync_dir(tmp)
    if os.path.exists(final):
        # park the live step under a .tmp name (invisible to a restore)
        # until its replacement is in place
        old = final + ".old.tmp"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(final, old)
        os.rename(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, final)
    fsync_dir(directory)
    return final


def shard_filename(leaf_i: int, process: int, shard: int) -> str:
    """A format-2 per-process shard file's name (the GC reaps those no
    manifest references)."""
    return f"leaf_{leaf_i:05d}_p{process:03d}_s{shard:03d}.npy"


def _valid(path: str, verify_sha: bool = False) -> bool:
    man = os.path.join(path, "manifest.json")
    if not os.path.isfile(man):
        return False
    try:
        with open(man) as f:
            m = json.load(f)
        for e in m["leaves"]:
            leaf = os.path.join(path, f"leaf_{e['i']:05d}.npy")
            if not os.path.isfile(leaf):
                return False
            if verify_sha and _sha(np.load(leaf)) != e["sha256"]:
                return False
        return True
    except (json.JSONDecodeError, KeyError, ValueError, OSError):
        return False


def _all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(name[5:]) for name in os.listdir(directory)
                  if name.startswith("step_") and not name.endswith(".tmp"))


def latest_step(directory: str) -> Optional[int]:
    """Newest valid step (skips .tmp and corrupt directories)."""
    steps = [s for s in _all_steps(directory)
             if _valid(os.path.join(directory, f"step_{s:08d}"))]
    return max(steps) if steps else None


def restorable_steps(directory: str, verify_sha: bool = True) -> List[int]:
    """Steps newest first that pass validation (every leaf's SHA-256 with
    verify_sha, else the files' presence); a step that fails is skipped
    with a warning."""
    out = []
    for step in reversed(_all_steps(directory)):
        path = os.path.join(directory, f"step_{step:08d}")
        if _valid(path, verify_sha=verify_sha):
            out.append(step)
        else:
            warnings.warn(f"skipping corrupt checkpoint {path} "
                          f"(failed {'SHA' if verify_sha else 'manifest'} "
                          f"verification)")
    return out


def latest_restorable(directory: str,
                      verify_sha: bool = True) -> Optional[int]:
    """Newest step that passes verification."""
    steps = restorable_steps(directory, verify_sha=verify_sha)
    return steps[0] if steps else None


def checkpoint_extra(directory: str, step: int) -> Dict:
    """One step's `extra` metadata: the manifest alone, no leaf read."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f).get("extra", {})


def load_leaves(directory: str, step: int,
                verify: bool = True) -> Tuple[List[np.ndarray], Dict]:
    """(flat leaf list, extra) of one step, from the manifest alone.
    Raises IOError on a SHA mismatch with verify (callers that fall back
    to the previous step catch it)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for e in manifest["leaves"]:
        arr = np.load(os.path.join(path, f"leaf_{e['i']:05d}.npy"))
        if verify and _sha(arr) != e["sha256"]:
            raise IOError(f"checkpoint leaf {e['i']} of step {step} failed "
                          f"integrity check")
        leaves.append(arr)
    return leaves, manifest.get("extra", {})


_SHARD_FILE_RE = re.compile(r"^leaf_\d{5}_p\d{3}_s\d{3}\.npy$")
_SHARD_RECORD_RE = re.compile(r"^shards_p\d{3}\.json$")


def _gc_orphan_shards(path: str) -> None:
    """Remove shard files a committed step's manifest does not reference,
    and the stale vote records (`shards_p*.json`) naming them; a step
    whose manifest does not parse is left alone."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        referenced = set()
        for e in manifest["leaves"]:
            if e.get("kind", "full") == "sharded":
                referenced.update(s["file"] for s in e["shards"])
            else:
                referenced.add(f"leaf_{e['i']:05d}.npy")
    except (OSError, json.JSONDecodeError, KeyError, TypeError, ValueError):
        return
    for name in os.listdir(path):
        full = os.path.join(path, name)
        stale = False
        if _SHARD_FILE_RE.match(name):
            stale = name not in referenced
        elif _SHARD_RECORD_RE.match(name):
            try:
                with open(full) as f:
                    entries = json.load(f)["entries"]
                stale = any(e["file"] not in referenced for e in entries)
            except (OSError, json.JSONDecodeError, KeyError, TypeError):
                stale = True
        if stale:
            try:
                os.remove(full)
            except OSError:
                pass


def gc_checkpoints(directory: str, keep: int) -> None:
    """Delete all but the newest `keep` steps, every `.tmp` step
    directory, and in each kept step the shard files its manifest does
    not reference; an `autotune/` subdirectory keeps its newest step."""
    if not os.path.isdir(directory):
        return
    steps = _all_steps(directory)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
    for name in os.listdir(directory):
        if name.startswith("step_") and name.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    for s in steps[-keep:] if keep > 0 else ():
        path = os.path.join(directory, f"step_{s:08d}")
        if os.path.isdir(path):
            _gc_orphan_shards(path)
    sub = os.path.join(directory, "autotune")
    if os.path.basename(directory) != "autotune" and os.path.isdir(sub):
        gc_checkpoints(sub, 1)
