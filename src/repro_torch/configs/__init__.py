"""Architecture registry of the port: ``get_config(name)`` / ``get_smoke(name)``.

The names are the reference's (``repro/configs/__init__.py``), all ported:
``mamba2-2.7b`` (SSM mixers with no FFN, the path that runs the SSD kernel),
the four dense decoders (GQA attention with RoPE and an MLP), the two MoE
models, the hybrid ``jamba-v0.1-52b`` (SSM and attention mixers, MLP and
MoE FFNs), the VLM backbone ``qwen2-vl-72b`` (M-RoPE, a stub vision
frontend: its inputs are patch embeddings) and the encoder-decoder
``whisper-tiny`` (a stub audio frontend: its inputs are frame embeddings;
cross-attention). An unknown name raises ``KeyError``, as in the reference.
"""

from __future__ import annotations

import importlib

from ..models.config import ArchConfig

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
