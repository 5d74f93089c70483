"""Checkpoints in ``repro``'s on-disk layout (``repro.checkpoint``): a
checkpoint written by either package opens in the other."""

from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    Checkpointer, Stacked, latest_step, restore_tree, save_tree,
)
