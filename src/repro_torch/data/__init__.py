"""Data pipeline: deterministic, counter-indexed synthetic token streams,
the port of ``repro.data``.

Every batch is a pure function of (seed, step): exactly resumable after a
restart. A real deployment swaps ``synthetic_batch`` for a tokenized shard
reader with the same (seed, step) -> global batch contract.
"""

from .pipeline import DataConfig, batch_iterator, synthetic_batch

__all__ = ["DataConfig", "batch_iterator", "synthetic_batch"]
