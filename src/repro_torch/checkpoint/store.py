"""Checkpoint store, formats 1 and 2 — counterpart of
`repro/checkpoint/store.py`.

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
  * Multi-process steps (format 2, the control plane of
    `launch/distributed.py`): each process writes its own rows of a
    sharded leaf straight from its device (`write_process_shards`, no
    gather) plus its vote record `shards_p<proc>.json`; the master alone
    writes the manifest (`commit_sharded_checkpoint`) and renames the
    step into place.  A host dying in between leaves a `.tmp` step that
    no restore selects; `load_leaves` reassembles a sharded leaf from
    its shards' index ranges.  File names, records, manifest and
    digests are the reference's, so each package reads the other's
    steps.
  * Keep-last-k GC, which also reaps `.tmp` step directories and shard
    files no manifest references.
  * Training state (`tree_leaves`, `restore_checkpoint`,
    `CheckpointManager`): a tree — NamedTuples, dicts, lists, tensors and
    the parameter modules of `models/params.py` — is written as the
    reference's `jax.tree.flatten` lists it: NamedTuple fields and lists
    in order, dict and `ParamTree` keys sorted, and each leaf of a
    `LayerStack` stacked over its layers into one array with a leading
    layer dim.  So each package resumes the other's training checkpoint.
    `CheckpointManager.save` copies the state to the host before it
    returns (the step after it updates the parameters in place) and may
    write in a thread.
  * Training state on a mesh of ranks (`CheckpointManager(shards=…)`,
    `host_leaves(tree, shards)`, `restore_checkpoint(..., shardings=…)`):
    every rank gathers each leaf whole on the step path, in leaf order
    (a collective in the writer thread would interleave with the step's),
    and the mesh's first rank writes format 1, byte for byte what one
    device writes for the same state.  A restore reads the whole leaves
    and cuts each rank's shard for the mesh live now, so a step written
    on one mesh resumes on another, on one device, or in the reference.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import threading
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.fingerprint import host_array
from repro_torch.models.params import map_params, tree_leaves


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
    _commit_rename(directory, tmp, final)
    return final


def _commit_rename(directory: str, tmp: str, final: str) -> None:
    """Rename a finished step into place, parking a live step of the same
    id under a .tmp name (invisible to a restore) until then."""
    fsync_dir(tmp)
    if os.path.exists(final):
        old = final + ".old.tmp"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(final, old)
        os.rename(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, final)
    fsync_dir(directory)


def shard_filename(leaf_i: int, process: int, shard: int) -> str:
    """A format-2 per-process shard file's name, keyed by (process,
    shard index)."""
    return f"leaf_{leaf_i:05d}_p{process:03d}_s{shard:03d}.npy"


def _shard_record_path(tmp_dir: str, process: int) -> str:
    return os.path.join(tmp_dir, f"shards_p{process:03d}.json")


def begin_sharded_checkpoint(directory: str, step: int) -> str:
    """Phase 0 (master only): the staging directory every process writes
    its shards into.  It stays `.tmp`, invisible to a restore, until
    `commit_sharded_checkpoint` renames it."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"step_{step:08d}.tmp")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    fsync_dir(directory)
    return tmp


def write_process_shards(tmp_dir: str, process: int,
                         indexed_leaves) -> int:
    """Phase 1 (every process): write this process's part of each sharded
    leaf.

    indexed_leaves: [(leaf_i, tensor, index)]: leaf_i is the leaf's place
    in the manifest's flat list, `tensor` this process's block (on any
    device; it is copied to the host here, with no gather), and `index`
    its (start, stop) per dim in the leaf's global shape.  A fourth
    element gives that global shape; without it the block must be the
    whole leaf.  One `shard_filename` .npy per distinct range (numbered
    in range order, as the reference numbers them), then the vote record
    `shards_p<proc>.json` (fsynced) listing them with ranges and SHA-256.
    Returns the number of shard files."""
    blocks: Dict[int, Dict] = {}
    shapes: Dict[int, Tuple[int, ...]] = {}
    for item in indexed_leaves:
        leaf_i, tensor, index = int(item[0]), item[1], item[2]
        idx = tuple((int(a), int(b)) for a, b in index)
        shape = (tuple(int(n) for n in item[3]) if len(item) > 3
                 else tuple(int(n) for n in tensor.shape))
        if len(idx) != tensor.ndim or len(shape) != tensor.ndim or any(
                b - a != n or a < 0 or b > g
                for (a, b), n, g in zip(idx, tensor.shape, shape)):
            raise ValueError(f"leaf {leaf_i}: index {idx} does not place a "
                             f"block of shape {tuple(tensor.shape)} in a "
                             f"leaf of shape {shape}")
        shapes[leaf_i] = shape
        blocks.setdefault(leaf_i, {}).setdefault(idx, tensor)
    entries = []
    for leaf_i, by_idx in blocks.items():
        for s, idx in enumerate(sorted(by_idx)):
            data = host_array(by_idx[idx])
            fname = shard_filename(leaf_i, process, s)
            _write_atomic(os.path.join(tmp_dir, fname),
                          lambda f, a=data: np.save(f, a), fsync=False)
            entries.append({
                "leaf": leaf_i, "shard": s, "file": fname,
                "index": [list(ab) for ab in idx],
                "shape": list(shapes[leaf_i]), "dtype": str(data.dtype),
                "sha256": _sha(data),
            })
    _write_atomic(_shard_record_path(tmp_dir, process),
                  lambda f: f.write(json.dumps(
                      {"process": int(process),
                       "entries": entries}).encode()))
    fsync_dir(tmp_dir)
    return len(entries)


def commit_sharded_checkpoint(directory: str, step: int, *,
                              num_processes: int, full_leaves,
                              extra: Optional[Dict] = None) -> str:
    """Phase 2 (master only): read every process's vote record, write the
    leaves the master holds whole, then the manifest (the one commit
    record), fsync, and rename the step into place.

    full_leaves: [(leaf_i, array)]; every other leaf index must be
    covered by the shard records.  Raises IOError when a process's record
    is missing (a host died in phase 1): the step stays `.tmp`."""
    tmp = os.path.join(directory, f"step_{step:08d}.tmp")
    final = os.path.join(directory, f"step_{step:08d}")
    sharded: Dict[int, List[Dict]] = {}
    for p in range(num_processes):
        rec_path = _shard_record_path(tmp, p)
        if not os.path.isfile(rec_path):
            raise IOError(
                f"checkpoint step {step}: missing shard record for "
                f"process {p} — refusing to commit a torn step")
        with open(rec_path) as f:
            for e in json.load(f)["entries"]:
                sharded.setdefault(int(e["leaf"]), []).append(e)
    leaves_meta = []
    for i, arr in full_leaves:
        if i in sharded:
            raise ValueError(f"leaf {i} is both full and sharded")
        arr = host_array(arr)
        _write_atomic(os.path.join(tmp, f"leaf_{i:05d}.npy"),
                      lambda f, a=arr: np.save(f, a), fsync=False)
        leaves_meta.append({"i": int(i), "kind": "full",
                            "shape": list(arr.shape),
                            "dtype": str(arr.dtype), "sha256": _sha(arr)})
    for i, ents in sharded.items():
        leaves_meta.append({
            "i": int(i), "kind": "sharded", "shape": ents[0]["shape"],
            "dtype": ents[0]["dtype"],
            "shards": [{"file": e["file"], "index": e["index"],
                        "sha256": e["sha256"]} for e in ents]})
    leaves_meta.sort(key=lambda e: e["i"])
    if [e["i"] for e in leaves_meta] != list(range(len(leaves_meta))):
        raise ValueError(
            f"leaf indices {[e['i'] for e in leaves_meta]} do not form a "
            f"contiguous flat list")
    manifest = {"format": 2, "step": int(step),
                "processes": int(num_processes),
                "extra": extra or {}, "leaves": leaves_meta}
    _write_atomic(os.path.join(tmp, "manifest.json"),
                  lambda f: f.write(json.dumps(manifest).encode()))
    _commit_rename(directory, tmp, final)
    return final


def _valid(path: str, verify_sha: bool = False) -> bool:
    man = os.path.join(path, "manifest.json")
    if not os.path.isfile(man):
        return False
    try:
        with open(man) as f:
            m = json.load(f)
        for e in m["leaves"]:
            if e.get("kind", "full") == "sharded":
                for srec in e["shards"]:
                    shard = os.path.join(path, srec["file"])
                    if not os.path.isfile(shard):
                        return False
                    if verify_sha and _sha(np.load(shard)) != srec["sha256"]:
                        return False
                continue
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
        if e.get("kind", "full") == "sharded":
            # format 2: the global leaf from its shards' index ranges
            # (replicated shards overwrite with identical bytes)
            arr = np.zeros(tuple(e["shape"]), np.dtype(e["dtype"]))
            for srec in e["shards"]:
                data = np.load(os.path.join(path, srec["file"]))
                if verify and _sha(data) != srec["sha256"]:
                    raise IOError(
                        f"checkpoint leaf {e['i']} shard {srec['file']} "
                        f"of step {step} failed integrity check")
                arr[tuple(slice(a, b) for a, b in srec["index"])] = data
            leaves.append(arr)
            continue
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


# ------------------------------------------------------ training state ----
def _leaf_shape(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(np.shape(leaf))


def _whole(t, shards):
    """A shard marked with its layout, gathered whole (t itself when it
    carries none)."""
    held = getattr(t, "_held", None)
    if shards is None or held is None:
        return t.detach()
    return shards.reshard(t.detach(), held, (None,) * t.dim())


def writes(shards) -> bool:
    """Whether this rank writes the mesh's checkpoints (its first rank;
    every process without a mesh)."""
    if shards is None:
        return True
    import torch.distributed as dist

    return dist.get_rank() == int(shards.mesh.mesh.reshape(-1)[0])


def host_leaves(tree, shards=None) -> Optional[List[np.ndarray]]:
    """The tree's leaves (`tree_leaves`) copied to host numpy arrays now
    (copies, never views of a tensor on the CPU), a `LayerStack` leaf
    stacked on its device first.  With `shards` (an `LMShards`) each
    leaf is this rank's shard, gathered whole over the mesh first by
    every rank; the mesh's first rank gets the arrays, the others None."""
    out = []
    mine = writes(shards)
    with torch.no_grad():
        for leaf in tree_leaves(tree):
            if isinstance(leaf, list):
                leaf = torch.stack([_whole(t, shards) for t in leaf])
            elif isinstance(leaf, torch.Tensor):
                leaf = _whole(leaf, shards)
                if leaf.device.type == "cpu":
                    leaf = leaf.clone()
            if mine:
                out.append(host_array(leaf))
    return out if mine else None


def restore_checkpoint(directory: str, step: int, like, shardings=None,
                       verify: bool = True):
    """Restore one step into the structure of `like` (a tree as
    `tree_leaves` reads it; its tensors may be on the `meta` device).
    Returns (tree, extra): new tensors of the checkpoint's values, each on
    its `like` leaf's device (the CPU for a meta leaf), or on
    `shardings` when it names a device; parameter modules keep each
    leaf's `requires_grad`.  With `shardings` an `LMShards` (a rank of a
    mesh) each leaf of `like` marked with a layout
    (`training/steps.py:abstract_train_state(..., mesh=)`) becomes this
    rank's shard of it on the rank's device, marked likewise: the
    reference's re-sharding onto the mesh live now.  A leaf count or a
    leaf shape that differs from `like`'s (whole shapes) raises
    ValueError, a failed SHA check IOError."""
    raw, extra = load_leaves(directory, step, verify=verify)
    want = tree_leaves(like)
    if len(want) != len(raw):
        raise ValueError(f"checkpoint has {len(raw)} leaves, model "
                         f"{len(want)}")
    for i, (leaf, arr) in enumerate(zip(want, raw)):
        if _leaf_shape(leaf) != tuple(arr.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != "
                             f"model {_leaf_shape(leaf)}")
    if shardings is None or isinstance(shardings, (str, torch.device)):
        device = None if shardings is None else torch.device(shardings)
        return _rebuild(like, iter(raw), device), extra
    from repro_torch.launch.mesh import mesh_device

    return _rebuild(like, iter(raw), mesh_device(shardings.mesh),
                    shardings), extra


def _placed(arr, like, device, shards=None) -> torch.Tensor:
    held = getattr(like, "_held", None)
    if shards is not None and held is not None:
        from repro_torch.serving.engine import _slices

        arr = arr[_slices(arr.shape, held, shards)]
    t = torch.from_numpy(np.array(arr))
    if device is None:
        device = getattr(like, "device", torch.device("cpu"))
        if device.type == "meta":
            device = torch.device("cpu")
    t = t.to(device)
    if shards is not None and held is not None:
        t._held = held
    return t


def _rebuild(tree, it, device, shards=None):
    """`tree`'s structure holding the next arrays of `it`, consumed in
    `tree_leaves` order (each rank's shard of them with `shards`)."""
    if tree is None:
        return None
    if isinstance(tree, nn.Module):
        vals = {}
        for leaf in tree_leaves(tree):
            arr = next(it)
            for j, p in enumerate(leaf if isinstance(leaf, list) else [leaf]):
                vals[id(p)] = _placed(arr[j] if isinstance(leaf, list)
                                      else arr, p, device, shards)
        new = map_params(lambda p: vals[id(p)], tree)
        for old, p in zip(tree.parameters(), new.parameters()):
            p.requires_grad_(old.requires_grad)
        return new
    if isinstance(tree, torch.Tensor):
        return _placed(next(it), tree, device, shards)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it, device, shards)
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_rebuild(t, it, device, shards) for t in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, it, device, shards) for t in tree)
    return next(it)


@dataclasses.dataclass
class CheckpointManager:
    """Periodic checkpoints of a training state: `save` copies the tree
    to the host at once and writes it (in a thread with `async_save`;
    one write at a time), then keeps the newest `keep` steps;
    `restore_latest` takes the newest step that restores, falling back
    to the previous one with a warning.

    With `shards` (a rank of a mesh) the tree holds the rank's shards:
    `save` gathers every leaf whole on every rank and the mesh's first
    rank writes; `restore_latest` waits for that rank's writes to end
    (a collective over the mesh) and cuts each rank's shards."""
    directory: str
    keep: int = 3
    async_save: bool = False
    shards: Any = None

    def __post_init__(self):
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree, extra: Optional[Dict] = None):
        # snapshot to host memory NOW: the next step updates the
        # parameters and moments in place
        host = host_leaves(tree, self.shards)
        if host is None:  # another rank writes
            return
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, extra)

    def _write(self, step, host, extra):
        save_checkpoint(self.directory, step, host, extra)
        gc_checkpoints(self.directory, self.keep)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, like, shardings=None):
        """(step, tree, extra) of the newest step that passes
        verification, skipping with a warning a step whose leaves fail
        their SHA check or do not fit `like`; (None, None, None) when
        none does."""
        self.wait()
        if self.shards is not None:
            # every rank reads what the writing rank has finished: the
            # writer joins the barrier once written, and the host reads
            # its result (an NCCL all_reduce returns before it ends)
            dims = tuple(self.shards.dims)
            from repro_torch.launch.mesh import mesh_device
            from repro_torch.sharding.activation import spec_entry

            self.shards._all_reduce(
                torch.zeros(1, device=mesh_device(self.shards.mesh)),
                spec_entry(dims)).item()
            shardings = self.shards
        for step in restorable_steps(self.directory, verify_sha=False):
            try:
                tree, extra = restore_checkpoint(self.directory, step,
                                                 like, shardings)
                return step, tree, extra
            except (IOError, ValueError) as e:
                warnings.warn(f"checkpoint step {step} failed restore "
                              f"({e}); trying the previous step")
        return None, None, None
