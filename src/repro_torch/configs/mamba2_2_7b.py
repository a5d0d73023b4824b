"""mamba2-2.7b — SSD (state-space duality), attention-free.
[arXiv:2405.21060] 64L d_model=2560 d_ff=0 vocab=50280 ssm_state=128."""

from dataclasses import replace

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
)


def smoke() -> ArchConfig:
    return replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        vocab_size=128,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=8,
    )
