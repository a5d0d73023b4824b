"""nemotron-4-340b — dense, GQA, squared-ReLU. [arXiv:2402.16819]
96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000."""

from dataclasses import replace

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    head_dim=192,
    act="sq_relu",
    rope_theta=1e4,
)


def smoke() -> ArchConfig:
    return replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=128,
    )
