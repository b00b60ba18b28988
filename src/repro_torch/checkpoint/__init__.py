"""Checkpointing: parameter-tree save/restore in the reference's format."""

from .io import latest_step, load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]
