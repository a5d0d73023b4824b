"""olmoe-1b-7b — MoE, 64 experts top-8. [arXiv:2409.02060; hf]
16L d_model=2048 16H (GQA kv=16) expert d_ff=1024 vocab=50304."""

from dataclasses import replace

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,                  # every FFN is MoE
    vocab_size=50304,
    n_experts=64,
    top_k=8,
    moe_d_ff=1024,
    moe_every=1,
    rope_theta=1e4,
)


def smoke() -> ArchConfig:
    return replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        vocab_size=128,
        n_experts=8,
        top_k=2,
        moe_d_ff=32,
    )
