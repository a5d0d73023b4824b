"""Architecture registry of the port: ``get_config(name)`` / ``get_smoke(name)``.

The names are the reference's (``repro/configs/__init__.py``), all ported:
``mamba2-2.7b`` (SSM mixers with no FFN, the path that runs the SSD kernel),
the four dense decoders (GQA attention with RoPE and an MLP), the two MoE
models, the hybrid ``jamba-v0.1-52b`` (SSM and attention mixers, MLP and
MoE FFNs), the VLM backbone ``qwen2-vl-72b`` (M-RoPE, a stub vision
frontend: its inputs are patch embeddings) and the encoder-decoder
``whisper-tiny`` (a stub audio frontend: its inputs are frame embeddings;
cross-attention). An unknown name raises ``KeyError``, as in the reference.
The run shapes and the (arch, shape) cells are the reference's too.
"""

from __future__ import annotations

import importlib

from ..models.config import SHAPES, ArchConfig, RunShape

ARCH_MODULES = {
    "mamba2-2.7b": "mamba2_2_7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "nemotron-4-340b": "nemotron_4_340b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "yi-34b": "yi_34b",
    "qwen2-1.5b": "qwen2_1_5b",
    "whisper-tiny": "whisper_tiny",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}

ARCH_NAMES = tuple(ARCH_MODULES)
PORTED = ARCH_NAMES

# long_500k requires sub-quadratic sequence handling: run for SSM/hybrid
# only; skip (documented, DESIGN.md §4) for pure full-attention archs.
LONG_CONTEXT_ARCHS = ("mamba2-2.7b", "jamba-v0.1-52b")


def _module(name: str):
    if name not in ARCH_MODULES:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCH_MODULES)}"
        )
    return importlib.import_module(f"{__name__}.{ARCH_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).smoke()


def get_shape(name: str) -> RunShape:
    return SHAPES[name]


def cell_is_skipped(arch: str, shape: str) -> str | None:
    """Returns the skip reason for a (arch, shape) cell, or None if it runs."""
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return (
            "long_500k needs sub-quadratic sequence mixing; "
            f"{arch} is pure full-attention (DESIGN.md §4)"
        )
    return None


def all_cells() -> list[tuple[str, str, str | None]]:
    """All 40 (arch, shape, skip_reason) cells."""
    return [
        (a, s, cell_is_skipped(a, s))
        for a in ARCH_NAMES
        for s in SHAPES
    ]
