"""Fault-tolerant checkpointing: atomic step dirs, async save, keep-k GC,
integrity manifest, and the elastic restore onto a mesh (``mesh=``,
``spec_tree=``). The port of ``repro.checkpoint``."""

from .manager import CheckpointManager, list_steps, restore_latest, save_checkpoint

__all__ = ["CheckpointManager", "list_steps", "restore_latest", "save_checkpoint"]
