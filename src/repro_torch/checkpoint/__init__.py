"""Checkpoints — counterpart of `repro.checkpoint`."""
from .store import (
    CheckpointManager,
    checkpoint_extra,
    fsync_dir,
    gc_checkpoints,
    latest_restorable,
    latest_step,
    load_leaves,
    restorable_steps,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.models.params import tree_leaves
