"""granite-moe-3b-a800m — MoE, 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]
32L d_model=1536 24H (GQA kv=8) expert d_ff=512 vocab=49155."""

from dataclasses import replace

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=0,
    vocab_size=49155,
    head_dim=64,
    n_experts=40,            # 40 % 16 != 0 -> 'ffn' MoE sharding policy
    top_k=8,
    moe_d_ff=512,
    moe_every=1,
)


def smoke() -> ArchConfig:
    return replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        vocab_size=128,
        n_experts=5,
        top_k=2,
        moe_d_ff=32,
    )
