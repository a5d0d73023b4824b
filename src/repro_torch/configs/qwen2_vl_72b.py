"""qwen2-vl-72b — VLM backbone with M-RoPE; vision frontend STUBBED
(input_specs supply precomputed patch embeddings). [arXiv:2409.12191; hf]
80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064."""

from dataclasses import replace

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    act="silu_glu",
    rope_theta=1e6,
    mrope=True,
    frontend="vision_stub",
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
