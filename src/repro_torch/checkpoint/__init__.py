"""Crash-safe tree checkpoints in the reference's on-disk format."""
from repro_torch.checkpoint.io import (CheckpointError,  # noqa: F401
                                       load_checkpoint, restore_checkpoint,
                                       save_checkpoint)
