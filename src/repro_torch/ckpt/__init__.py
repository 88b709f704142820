"""Checkpointing: atomic save and validated restore, in the JAX package's
on-disk layout."""

from repro_torch.ckpt.checkpoint import (  # noqa: F401
    latest_step, load_checkpoint, prune_steps, read_meta, restore_into, save_checkpoint,
)
