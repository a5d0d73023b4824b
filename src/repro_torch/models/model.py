"""The decoder-only language model's entry points: initialization, the
train/prefill forward, and the decode step. The port of
``repro/models/model.py`` for the dense decoders, the Mamba2 family, the
MoE models and the hybrid.

``init_params`` puts the model on the card unless the caller passes
``device="cpu"``. Forward and decode run without autograd: the port
serves; ``loss_fn`` waits for the training slice (ROADMAP Queue 1 item
15d), ``param_specs`` and ``cache_specs`` for the mesh layer (15f), and the
encoder-decoder model and ``embeds`` inputs for 15c. As in the reference,
prefill hands no state to decode: ``decode_step`` starts from
``init_decode_state``'s zeroed caches.
"""

from __future__ import annotations

import torch
from torch import nn

from ..engine.context import check_device
from .blocks import apply_stack, apply_stack_decode, init_stack, init_stack_cache
from .config import ArchConfig
from .layers import Embedding, Norm, apply_norm, embed_tokens, init_embedding, init_norm
from .layers import logits as lm_logits

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MODES = ("train", "prefill")
LOGITS_POSITIONS = ("all", "last")


class LM(nn.Module):
    """``embed`` (the token table and, untied, the head), ``final_norm`` and
    ``blocks`` (one layer each), named as the reference's pytree."""

    def __init__(self, embed: Embedding, final_norm: Norm, blocks: nn.ModuleList):
        super().__init__()
        self.embed = embed
        self.final_norm = final_norm
        self.blocks = blocks


def _check_encdec(cfg: ArchConfig) -> None:
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder model waits for "
                                  f"ROADMAP Queue 1 item 15c")


def init_params(cfg: ArchConfig, *, generator: torch.Generator, device="cuda",
                dtype: torch.dtype | None = None) -> LM:
    """The model with weights drawn from ``generator`` (on ``device``) in
    the reference's distributions, in ``dtype`` (default the config's)."""
    dev = check_device(device, "init_params")
    _check_encdec(cfg)
    dtype = dtype or DTYPES[cfg.dtype]
    return LM(init_embedding(generator, cfg, dtype, dev), init_norm(cfg, dtype, dev),
              init_stack(generator, cfg, dtype, dev))


@torch.no_grad()
def forward(params: LM, cfg: ArchConfig, batch: dict, *, mode: str = "train",
            logits_positions: str = "all") -> tuple[torch.Tensor, torch.Tensor]:
    """-> (logits (B, S, V), moe_aux: the MoE layers' load-balancing losses
    summed, 0 without MoE); ``logits_positions="last"`` (what a prefill
    serves) gives (B, 1, V). ``batch`` carries 'tokens' (B, S) and
    optionally 'positions' (B, S), else 0..S-1. ``mode="prefill"`` runs
    attention blockwise (:func:`~repro_torch.models.attention.flash_attention`);
    the SSM and MoE layers compute the same in both modes."""
    _check_encdec(cfg)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if logits_positions not in LOGITS_POSITIONS:
        raise ValueError(f"logits_positions must be one of {LOGITS_POSITIONS}, "
                         f"got {logits_positions!r}")
    if cfg.frontend != "none" or "embeds" in batch:
        raise NotImplementedError(f"{cfg.name}: 'embeds' inputs (the stub frontend) wait "
                                  f"for ROADMAP Queue 1 item 15c")
    x = embed_tokens(params.embed, batch["tokens"])
    b, s = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    x, aux = apply_stack(params.blocks, x, cfg, positions, mode=mode)
    x = apply_norm(params.final_norm, x)
    if logits_positions == "last":
        x = x[:, -1:, :]
    return lm_logits(params.embed, x, vocab_size=cfg.vocab_size), aux


def init_decode_state(params: LM, cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """Zeroed caches for ``batch`` sequences: ``max_len`` positions for each
    attention layer's K and V; an SSM layer's state has no length."""
    _check_encdec(cfg)
    return {"caches": init_stack_cache(params.blocks, cfg, batch, max_len,
                                       params.embed.table.dtype)}


@torch.no_grad()
def decode_step(params: LM, cfg: ArchConfig, state: dict, tokens: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
    """One serving step: next-token logits (B, 1, V) + updated caches.
    ``tokens``: (B, 1) integers."""
    _check_encdec(cfg)
    x = embed_tokens(params.embed, tokens)
    x, caches = apply_stack_decode(params.blocks, state["caches"], x, cfg)
    x = apply_norm(params.final_norm, x)
    return lm_logits(params.embed, x, vocab_size=cfg.vocab_size), {"caches": caches}
