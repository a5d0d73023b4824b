"""Shape-only stand-ins for every model input, the port of
``repro/launch/specs.py``: the dry run (:mod:`repro_torch.launch.dryrun`)
steps on tensors of these shapes and dtypes. Each is a tensor on the
``meta`` device, the port's ``jax.ShapeDtypeStruct``: a shape and a dtype,
nothing allocated."""

from __future__ import annotations

import torch

from ..configs import get_config
from ..models import ArchConfig
from ..models.config import SHAPES, RunShape
from ..models.model import DTYPES


def _struct(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ArchConfig, shape: RunShape) -> dict:
    """The training/prefill batch: ``embeds`` (B, S, D) for a stub frontend,
    else ``tokens`` (B, S); ``dec_tokens``/``dec_labels`` (B, T) for the
    encoder-decoder model, else ``labels`` (B, S)."""
    b, s = shape.global_batch, shape.seq_len
    out = {}
    if cfg.frontend != "none":
        out["embeds"] = _struct((b, s, cfg.d_model), DTYPES[cfg.dtype])
    else:
        out["tokens"] = _struct((b, s), torch.int32)
    if cfg.is_encdec:
        t = cfg.max_target_len
        out["dec_tokens"] = _struct((b, t), torch.int32)
        out["dec_labels"] = _struct((b, t), torch.int32)
    else:
        out["labels"] = _struct((b, s), torch.int32)
    return out


def decode_token_struct(cfg: ArchConfig, shape: RunShape) -> torch.Tensor:
    return _struct((shape.global_batch, 1), torch.int32)


def cross_kv_struct(cfg: ArchConfig, shape: RunShape) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder K/V a whisper decode step reads: (B, S_enc, kv, hd), twice."""
    kv = (shape.global_batch, shape.seq_len, cfg.n_kv_heads, cfg.hd)
    return (_struct(kv, DTYPES[cfg.dtype]),) * 2


def input_specs(arch: str, shape_name: str) -> dict:
    """Every input struct of an (arch, shape) cell."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind in ("train", "prefill"):
        return {"batch": batch_struct(cfg, shape)}
    return {"tokens": decode_token_struct(cfg, shape)}
