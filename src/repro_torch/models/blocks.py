"""Layer blocks and the stack of layers: the port of
``repro/models/blocks.py`` for the attention and SSM mixers, cross-attention
on an encoder's states, and the MLP and MoE FFNs (the dense decoders, the
Mamba2 family, the MoE models, the hybrid and the encoder-decoder model).

The reference stacks each period position's parameters over the layer
groups and drives them with ``lax.scan`` (and remat); the port holds one
:class:`Layer` module per layer in an ``nn.ModuleList`` and runs a plain
loop over the same groups of ``cfg.block_period`` layers, each group
checkpointed as the reference's scan body is (:func:`_remat`). Every
function takes the sharding policy as the keyword ``sh``; a group's output
is laid out over ('dp', 'sp' under ``sp_activations``), as the
reference's scan carry is.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from .attention import (
    Attention,
    KVCache,
    attention,
    attention_decode,
    attention_prefill,
    init_attn,
    init_cache,
)
from .config import ArchConfig
from .layers import MLP, Norm, apply_mlp, apply_norm, init_mlp, init_norm
from .moe import MoE, apply_moe, init_moe
from .sharding import NULL, Sharding, grad_as_input
from .ssm import SSM, SSMCache, apply_ssm, apply_ssm_decode, init_ssm, init_ssm_cache


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


class Layer(nn.Module):
    """One layer: ``norm1`` then its mixer (``attn`` or ``ssm``), added to
    the residual; in a decoder layer of the encoder-decoder model,
    ``norm_x`` then cross-attention (``xattn``) on the encoder's states,
    added too; where the layer has an FFN, ``norm2`` then ``mlp`` or
    ``moe``, added too. Absent parts are None."""

    def __init__(self, norm1: Norm, *, attn: Attention | None = None, ssm: SSM | None = None,
                 norm_x: Norm | None = None, xattn: Attention | None = None,
                 norm2: Norm | None = None, mlp: MLP | None = None, moe: MoE | None = None):
        super().__init__()
        if (attn is None) == (ssm is None):
            raise ValueError("a layer has one mixer: attn or ssm")
        if (norm_x is None) != (xattn is None):
            raise ValueError("a layer has norm_x with xattn, or neither")
        if (norm2 is None) != (mlp is None and moe is None) or (
                mlp is not None and moe is not None):
            raise ValueError("a layer has norm2 with one FFN (mlp or moe), or neither")
        self.norm1, self.attn, self.ssm = norm1, attn, ssm
        self.norm_x, self.xattn = norm_x, xattn
        self.norm2, self.mlp, self.moe = norm2, mlp, moe

    @property
    def ffn(self) -> str:
        """The FFN this layer holds: 'moe', 'mlp' or ''."""
        return "moe" if self.moe is not None else "mlp" if self.mlp is not None else ""


def check_ffn(p: Layer, cfg: ArchConfig, layer: int) -> str:
    """The layer's FFN kind; ``ValueError`` where the model's layer lacks
    the FFN the config asks for (or holds another)."""
    ffn = layer_kind(cfg, layer)[1]
    if p.ffn != ffn:
        raise ValueError(f"{cfg.name} layer {layer}: the config asks for FFN "
                         f"{ffn or 'none'!r}, the model's layer holds {p.ffn or 'none'!r}")
    return ffn


def check_cross(p: Layer, cfg: ArchConfig, layer: int) -> None:
    """``ValueError`` where the call needs the layer's cross-attention and
    the model's layer holds none."""
    if p.xattn is None:
        raise ValueError(f"{cfg.name} layer {layer}: the call needs cross-attention, the "
                         f"model's layer holds none")


def _apply_cross(p: Layer, x: torch.Tensor, cfg: ArchConfig,
                 cross_kv: tuple[torch.Tensor, torch.Tensor], sh: Sharding) -> torch.Tensor:
    """x plus cross-attention on ``norm_x(x)`` against the encoder's K/V
    (unroped and unmasked: no positions)."""
    hx = _normed(p.norm_x, x, sh)
    return x + attention(p.xattn, hx, cfg, None, kv_override=cross_kv, sh=sh)


def _normed(norm: Norm, x: torch.Tensor, sh: Sharding) -> torch.Tensor:
    """``norm(x)`` with its sequence whole (the all-gather at the
    Megatron-SP boundary, under ``sp_activations``), as the projections
    that read it flatten (batch, sequence). Its gradient is laid out once
    as the output is (a pending sum left pending) before the norm's
    elementwise backward runs: a projection's backward may hand it split
    on the width, and each of those ops would then gather it again."""
    return grad_as_input(sh.constrain(apply_norm(norm, x), "dp", None, None))


def _apply_mixer(p: Layer, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                 mode: str, causal: bool, sh: Sharding) -> torch.Tensor:
    """x plus the layer's mixer (attention, or the SSM) on ``norm1(x)``.
    The normed input and the mixer's output are dead once it returns, as
    in XLA's program: the FFN's temporaries do not sit beside them."""
    h = _normed(p.norm1, x, sh)
    if p.attn is None:
        return x + apply_ssm(p.ssm, h, cfg, sh=sh)
    if mode == "prefill":
        return x + attention_prefill(p.attn, h, cfg, positions, sh=sh)[0]
    return x + attention(p.attn, h, cfg, positions, causal=causal, sh=sh)


def _apply_ffn(p: Layer, x: torch.Tensor, cfg: ArchConfig, layer: int, sh: Sharding
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """x plus the layer's FFN on ``norm2(x)``, and the MoE's aux loss (None
    without an MoE)."""
    ffn = check_ffn(p, cfg, layer)
    if not ffn:
        return x, None
    h = _normed(p.norm2, x, sh)
    if ffn == "moe":
        f, aux = apply_moe(p.moe, h, cfg, sh=sh)
        return x + f, aux
    return x + apply_mlp(p.mlp, h, cfg, sh=sh), None


def init_layer(gen: torch.Generator, cfg: ArchConfig, layer: int, dtype, device="cuda",
               cross_attn: bool = False) -> Layer:
    mixer, ffn = layer_kind(cfg, layer)
    norm1 = init_norm(cfg, dtype, device)
    mix = ({"attn": init_attn(gen, cfg, dtype, device)} if mixer == "attn"
           else {"ssm": init_ssm(gen, cfg, dtype, device)})
    if cross_attn:
        mix["norm_x"] = init_norm(cfg, dtype, device)
        mix["xattn"] = init_attn(gen, cfg, dtype, device)
    if ffn:
        mix["norm2"] = init_norm(cfg, dtype, device)
        mix[ffn] = (init_moe(gen, cfg, dtype, device) if ffn == "moe"
                    else init_mlp(gen, cfg, cfg.d_ff, dtype, device))
    return Layer(norm1, **mix)


def apply_layer(p: Layer, x: torch.Tensor, cfg: ArchConfig, layer: int, positions: torch.Tensor,
                *, mode: str = "train", causal: bool = True,
                cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None, sh: Sharding = NULL
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x_out, moe_aux_loss); with no MoE FFN the aux loss is 0.
    ``mode="prefill"`` runs attention as :func:`flash_attention`, causal
    whatever ``causal`` says, as in the reference; the MoE is the same in
    both modes. ``cross_kv``, the encoder's K/V, adds cross-attention after
    the mixer."""
    if cross_kv is not None:
        check_cross(p, cfg, layer)
    x = _apply_mixer(p, x, cfg, positions, mode, causal, sh)
    if cross_kv is not None:
        x = _apply_cross(p, x, cfg, cross_kv, sh)
    x, aux = _apply_ffn(p, x, cfg, layer, sh)
    return x, torch.zeros((), dtype=torch.float32, device=x.device) if aux is None else aux


def init_stack(gen: torch.Generator, cfg: ArchConfig, dtype, device="cuda",
               n_layers: int | None = None, cross_attn: bool = False) -> nn.ModuleList:
    """One :class:`Layer` per layer (``n_layers``, default the config's),
    drawn in layer order from ``gen``; ``cross_attn`` gives each its
    cross-attention (the encoder-decoder model's decoder)."""
    n_layers = cfg.n_layers if n_layers is None else n_layers
    return nn.ModuleList(init_layer(gen, cfg, layer, dtype, device, cross_attn=cross_attn)
                         for layer in range(n_layers))


#: What ``remat="dots"`` keeps from the forward: the products' outputs,
#: as ``jax.checkpoint_policies.checkpoint_dots`` keeps ``dot_general``'s.
DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                  torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ArchConfig):
    """``fn`` under activation checkpointing, as ``cfg.remat`` asks (the
    reference's ``_remat``): ``"none"`` none, ``"dots"`` keeping only the
    products' outputs (:data:`DOTS`), anything else (``"full"``) keeping
    only ``fn``'s inputs. Only under autograd: a forward without gradients
    (serving) runs ``fn`` as it is. ``ssd_intra``'s kernel is no aten op,
    so under both it runs again in the backward's recompute."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        dots = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=dots)
    return functools.partial(checkpoint, fn, use_reentrant=False)


def apply_stack(stack: nn.ModuleList, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                *, mode: str = "train", causal: bool = True,
                cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None, sh: Sharding = NULL
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The layers in order, a group of ``cfg.block_period`` layers at a
    time, each group under :func:`_remat`. Returns (x, total_moe_aux)."""
    period = cfg.block_period

    def group(first: int, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for layer in range(first, min(first + period, len(stack))):
            h, a = apply_layer(stack[layer], h, cfg, layer, positions, mode=mode, causal=causal,
                               cross_kv=cross_kv, sh=sh)
            aux = aux + a
        return sh.constrain(h, "dp", "sp" if sh.sp_activations else None, None), aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for first in range(0, len(stack), period):
        x, a = _remat(functools.partial(group, first), cfg)(x)
        aux = aux + a
    return x, aux


def init_stack_cache(stack: nn.ModuleList, cfg: ArchConfig, batch: int, max_len: int, dtype
                     ) -> list[KVCache | SSMCache]:
    """One zeroed cache per layer: a :class:`KVCache` of ``max_len``
    positions for an attention layer, an SSM state for an SSM layer. Under
    an encoder-decoder config the stack is the decoder, whose every layer
    holds cross-attention."""
    caches: list[KVCache | SSMCache] = []
    for layer, p in enumerate(stack):
        if cfg.is_encdec:
            check_cross(p, cfg, layer)
        device = p.norm1.scale.device
        caches.append(init_cache(cfg, batch, max_len, dtype, device) if p.attn is not None
                      else init_ssm_cache(cfg, batch, dtype, device))
    return caches


def apply_stack_decode(stack: nn.ModuleList, caches: list, x: torch.Tensor, cfg: ArchConfig,
                       cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None, *,
                       sh: Sharding = NULL) -> tuple[torch.Tensor, list]:
    """One-token decode through the stack. x: (B, 1, D). An MoE layer's
    aux loss is discarded, as in the reference. Cross-attention runs where
    ``cross_kv`` is given and the layer holds it; without ``cross_kv`` it
    is skipped, as the reference skips it."""
    new_caches = []
    for layer, (p, cache) in enumerate(zip(stack, caches)):
        h = apply_norm(p.norm1, x)
        if p.attn is not None:
            a, cache = attention_decode(p.attn, h, cache, cfg, sh=sh)
        else:
            a, cache = apply_ssm_decode(p.ssm, h, cache, cfg, sh=sh)
        x = x + a
        if cross_kv is not None and p.xattn is not None:
            x = _apply_cross(p, x, cfg, cross_kv, sh)
        x, _ = _apply_ffn(p, x, cfg, layer, sh)
        new_caches.append(cache)
    return x, new_caches
