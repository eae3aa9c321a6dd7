"""Checkpoints — counterpart of `repro.checkpoint`."""
from .store import (
    CheckpointManager,
    begin_sharded_checkpoint,
    checkpoint_extra,
    commit_sharded_checkpoint,
    fsync_dir,
    gc_checkpoints,
    latest_restorable,
    latest_step,
    load_leaves,
    restorable_steps,
    restore_checkpoint,
    save_checkpoint,
    write_process_shards,
)
from repro_torch.models.params import tree_leaves
