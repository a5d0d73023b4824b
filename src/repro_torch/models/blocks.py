"""Layer blocks and the stack of layers: the port of
``repro/models/blocks.py`` for the SSM mixer with no FFN (the Mamba2
family).

The reference stacks each period position's parameters over the layer
groups and drives them with ``lax.scan`` (and remat); the port holds one
:class:`Layer` module per layer in an ``nn.ModuleList`` and runs a plain
loop. Attention, MoE, MLP and cross-attention layers wait for ROADMAP
Queue 1 item 15 and raise by name; the reference's arguments that only
they read (positions, the prefill mode, cross-attention K/V) are not taken.
"""

from __future__ import annotations

import torch
from torch import nn

from .config import ArchConfig
from .layers import Norm, apply_norm, init_norm
from .ssm import SSM, SSMCache, apply_ssm, apply_ssm_decode, init_ssm, init_ssm_cache

_WAITS = "waits for ROADMAP Queue 1 item 15"


def layer_kind(cfg: ArchConfig, layer: int) -> tuple[str, str]:
    """(mixer, ffn) kind for a layer index: ('attn'|'ssm', 'moe'|'mlp'|'')."""
    mixer = "attn" if cfg.is_attn_layer(layer) else "ssm"
    if cfg.is_moe_layer(layer):
        ffn = "moe"
    elif cfg.d_ff:
        ffn = "mlp"
    else:
        ffn = ""
    return mixer, ffn


def check_ported(cfg: ArchConfig, layer: int) -> None:
    """Raise ``NotImplementedError`` for a layer the port cannot run yet."""
    mixer, ffn = layer_kind(cfg, layer)
    if mixer == "attn":
        raise NotImplementedError(f"{cfg.name} layer {layer}: the attention mixer {_WAITS}")
    if ffn:
        raise NotImplementedError(f"{cfg.name} layer {layer}: the {ffn.upper()} FFN {_WAITS}")


class Layer(nn.Module):
    """One SSM layer: ``norm1`` then the ``ssm`` mixer, added to the residual."""

    def __init__(self, norm1: Norm, ssm: SSM):
        super().__init__()
        self.norm1 = norm1
        self.ssm = ssm


def init_layer(gen: torch.Generator, cfg: ArchConfig, layer: int, dtype, device="cuda"
               ) -> Layer:
    check_ported(cfg, layer)
    return Layer(init_norm(cfg, dtype, device), init_ssm(gen, cfg, dtype, device))


def apply_layer(p: Layer, x: torch.Tensor, cfg: ArchConfig, layer: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x_out, moe_aux_loss); an SSM layer's aux loss is 0."""
    check_ported(cfg, layer)
    x = x + apply_ssm(p.ssm, apply_norm(p.norm1, x), cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def init_stack(gen: torch.Generator, cfg: ArchConfig, dtype, device="cuda") -> nn.ModuleList:
    """One :class:`Layer` per layer, drawn in layer order from ``gen``."""
    return nn.ModuleList(init_layer(gen, cfg, layer, dtype, device)
                         for layer in range(cfg.n_layers))


def apply_stack(stack: nn.ModuleList, x: torch.Tensor, cfg: ArchConfig
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The layers in order. Returns (x, total_moe_aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, p in enumerate(stack):
        x, a = apply_layer(p, x, cfg, layer)
        aux = aux + a
    return x, aux


def init_stack_cache(stack: nn.ModuleList, cfg: ArchConfig, batch: int, dtype
                     ) -> list[SSMCache]:
    """One zeroed cache per layer."""
    caches = []
    for layer, p in enumerate(stack):
        check_ported(cfg, layer)
        caches.append(init_ssm_cache(cfg, batch, dtype, p.ssm.wz.device))
    return caches


def apply_stack_decode(stack: nn.ModuleList, caches: list[SSMCache], x: torch.Tensor,
                       cfg: ArchConfig) -> tuple[torch.Tensor, list[SSMCache]]:
    """One-token decode through the stack. x: (B, 1, D)."""
    new_caches = []
    for layer, (p, cache) in enumerate(zip(stack, caches)):
        check_ported(cfg, layer)
        a, cache = apply_ssm_decode(p.ssm, apply_norm(p.norm1, x), cache, cfg)
        x = x + a
        new_caches.append(cache)
    return x, new_caches
