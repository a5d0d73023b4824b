"""whisper-tiny — encoder-decoder audio backbone, conv frontend STUBBED
(input_specs supply precomputed frame embeddings). [arXiv:2212.04356]
4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865."""

from dataclasses import replace

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,               # 6 % 16 != 0 -> context-parallel attention
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    act="gelu",
    norm="layernorm",
    is_encdec=True,
    dec_layers=4,
    max_target_len=448,
    frontend="audio_stub",
    tie_embeddings=True,
)


def smoke() -> ArchConfig:
    return replace(
        CONFIG,
        n_layers=2,
        dec_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        max_target_len=16,
    )
