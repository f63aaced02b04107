"""Checkpoints in the reference's npy + manifest layout."""

from repro_torch.checkpoint.store import (CheckpointManager,  # noqa: F401
                                          config_fingerprint, latest_step,
                                          load_checkpoint, save_checkpoint)
