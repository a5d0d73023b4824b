"""Architecture registry of the port: ``get_config(name)`` / ``get_smoke(name)``.

The names are the reference's (``repro/configs/__init__.py``). Only
``mamba2-2.7b`` is ported: its layers are SSM mixers with no FFN, the path
that runs the SSD kernel. The other nine names are known and raise
``NotImplementedError`` until their layers (attention, RoPE, MoE, MLP,
encoder-decoder) are ported (ROADMAP Queue 1 item 15); an unknown name
raises ``KeyError``, as in the reference.
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
PORTED = ("mamba2-2.7b",)


def _module(name: str):
    if name not in ARCH_MODULES:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCH_MODULES)}"
        )
    if name not in PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: its attention, RoPE, MoE, MLP or "
            f"encoder-decoder layers wait for ROADMAP Queue 1 item 15; ported: {PORTED}"
        )
    return importlib.import_module(f"{__name__}.{ARCH_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).smoke()
