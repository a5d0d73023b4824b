"""Architecture registry of the port: ``get_config(name)`` / ``get_smoke(name)``.

The names are the reference's (``repro/configs/__init__.py``). Ported are
``mamba2-2.7b`` (SSM mixers with no FFN, the path that runs the SSD kernel),
the four dense decoders (GQA attention with RoPE and an MLP), the two MoE
models and the hybrid ``jamba-v0.1-52b`` (SSM and attention mixers, MLP
and MoE FFNs). The other two names are known and raise
``NotImplementedError`` naming the ROADMAP Queue 1 sub-slice their layers
wait for (M-RoPE positions, the vision frontend and the encoder-decoder
model: item 15c); an unknown name raises ``KeyError``, as in the reference.
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
PORTED = ("mamba2-2.7b", "qwen2-1.5b", "deepseek-coder-33b", "yi-34b", "nemotron-4-340b",
          "olmoe-1b-7b", "granite-moe-3b-a800m", "jamba-v0.1-52b")
#: The sub-slice each unported name waits for.
WAITS = {"qwen2-vl-72b": "15c", "whisper-tiny": "15c"}


def _module(name: str):
    if name not in ARCH_MODULES:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCH_MODULES)}"
        )
    if name not in PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: its layers wait for ROADMAP Queue 1 item "
            f"{WAITS[name]}; ported: {PORTED}"
        )
    return importlib.import_module(f"{__name__}.{ARCH_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).smoke()
