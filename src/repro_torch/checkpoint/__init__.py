"""Fault-tolerant checkpointing: atomic step dirs, async save, keep-k GC,
integrity manifest. The port of ``repro.checkpoint``; the elastic restore
onto a mesh waits for the mesh layer (ROADMAP Queue 1 item 15f)."""

from .manager import CheckpointManager, list_steps, restore_latest, save_checkpoint

__all__ = ["CheckpointManager", "list_steps", "restore_latest", "save_checkpoint"]
