"""Checkpoints of the port (``repro.checkpoint`` on PyTorch), in the
reference's on-disk format."""
from repro_torch.checkpoint.checkpoint import (
    gc_checkpoints,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["gc_checkpoints", "latest_step", "restore_checkpoint", "save_checkpoint"]
