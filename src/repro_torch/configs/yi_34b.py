"""yi-34b — dense llama-arch GQA. [arXiv:2403.04652; hf]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000."""

from dataclasses import replace

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,              # 56 % 16 != 0 -> context-parallel attention
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    act="silu_glu",
    rope_theta=5e6,
)


def smoke() -> ArchConfig:
    return replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
    )
