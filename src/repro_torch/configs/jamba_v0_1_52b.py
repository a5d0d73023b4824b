"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave with MoE 16e top-2.
[arXiv:2403.19887; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.

Layer pattern (period 8): attention at position 4, Mamba elsewhere; MoE FFN
at odd positions (16 MoE layers total), dense FFN at even positions.
Jamba's Mamba-1 layers are realized with the SSD formulation at Jamba's
dimensions (d_state=16), as in the reference.
"""

from dataclasses import replace

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    act="silu_glu",
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
)


def smoke() -> ArchConfig:
    return replace(
        CONFIG,
        n_layers=8,            # one full period
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        n_experts=4,
        top_k=2,
        moe_d_ff=64,
        ssm_state=8,
        ssm_head_dim=16,
        ssm_chunk=8,
    )
