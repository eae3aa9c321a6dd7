"""Checkpoints — counterpart of `repro.checkpoint` (format 1, one writer)."""
from .store import (
    checkpoint_extra,
    fsync_dir,
    gc_checkpoints,
    latest_restorable,
    latest_step,
    load_leaves,
    restorable_steps,
    save_checkpoint,
)
