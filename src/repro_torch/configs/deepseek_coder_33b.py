"""deepseek-coder-33b — dense llama-arch GQA. [arXiv:2401.14196; hf]
62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256."""

from dataclasses import replace

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,              # 56 % 16 != 0 -> context-parallel attention
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    head_dim=128,
    act="silu_glu",
    rope_theta=1e5,
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
