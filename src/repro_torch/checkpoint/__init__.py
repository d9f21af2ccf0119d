"""Checkpoints in the JAX package's on-disk format (the port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.store import load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager"]
