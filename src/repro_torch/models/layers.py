"""Shared neural layers of the language models: initializers, norms, token
embedding and logits. The port of ``repro/models/layers.py``; RoPE and the
MLP wait for the layers that use them (ROADMAP Queue 1 item 15).

Parameters live in :class:`Params` modules whose parameter names are the
reference's dict keys, so a reference pytree converts leaf by leaf
(:func:`repro_torch.convert.lm_from_numpy`). They are created without
gradients: the port serves (prefill and decode); training waits for its
slice. f32 where numerically sensitive, the config's dtype elsewhere, as in
the reference.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
from torch import nn

from .config import ArchConfig


class Params(nn.Module):
    """A module holding named tensors as parameters without gradients;
    ``names`` lists the keys it must have, ``optional`` those it may have."""

    names: tuple[str, ...] = ()
    optional: tuple[str, ...] = ()

    def __init__(self, tensors: Mapping[str, torch.Tensor]):
        super().__init__()
        missing = set(self.names) - set(tensors)
        extra = set(tensors) - set(self.names) - set(self.optional)
        if missing or extra:
            raise ValueError(f"{type(self).__name__}: missing {sorted(missing)}, "
                             f"unexpected {sorted(extra)}")
        for name in self.optional:
            if name not in tensors:
                self.register_parameter(name, None)
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def __contains__(self, name: str) -> bool:
        return getattr(self, name, None) is not None


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)


def dense_init(gen: torch.Generator, shape, in_axis: int = -2, dtype=torch.bfloat16,
               device="cuda") -> torch.Tensor:
    """N(0, 1/fan_in) in f32, cast to ``dtype`` (the reference's distribution;
    its bits come from ``jax.random`` and cannot be reproduced)."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    std = 1.0 / math.sqrt(fan_in)
    return (_normal(gen, shape, device) * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    return (_normal(gen, shape, device) * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

class Norm(Params):
    """rmsnorm (``scale``) or layernorm (``scale`` and ``bias``)."""

    names = ("scale",)
    optional = ("bias",)


def init_norm(cfg: ArchConfig, dtype, device="cuda") -> Norm:
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return Norm(p)


def apply_norm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p.scale.float() + p.bias.float()
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p.scale.float()
    return out.to(dtype)


# --------------------------------------------------------------------------
# embedding + logits
# --------------------------------------------------------------------------

class Embedding(Params):
    """The token table ``(padded_vocab, d_model)`` and, untied, the head
    ``(d_model, padded_vocab)``."""

    names = ("table",)
    optional = ("head",)


def init_embedding(gen: torch.Generator, cfg: ArchConfig, dtype, device="cuda") -> Embedding:
    v = cfg.padded_vocab
    p = {"table": embed_init(gen, (v, cfg.d_model), dtype, device)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, v), dtype=dtype, device=device)
    return Embedding(p)


def embed_tokens(p: Embedding, ids: torch.Tensor) -> torch.Tensor:
    return p.table[ids]


def logits(p: Embedding, x: torch.Tensor, vocab_size: int | None = None) -> torch.Tensor:
    head = p.head if "head" in p else p.table.T
    out = torch.matmul(x, head)
    v_pad = head.shape[-1]
    if vocab_size is not None and vocab_size < v_pad:
        # mask padded vocab rows so softmax/argmax never see them
        mask = torch.arange(v_pad, device=out.device) < vocab_size
        out = torch.where(mask, out, torch.tensor(-1e30, dtype=out.dtype, device=out.device))
    return out
