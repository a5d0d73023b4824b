"""qwen2-1.5b — dense GQA with QKV bias. [arXiv:2407.10671; hf]
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936."""

from dataclasses import replace

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,              # 12 % 16 != 0 -> context-parallel attention
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    act="silu_glu",
    rope_theta=1e6,
    tie_embeddings=True,
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
