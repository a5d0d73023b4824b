"""Khatri-Rao product and the MTTKRP-via-matrix-multiplication baseline
(paper §III-B, §VI). Counterpart of ``repro.core.krp``."""

from __future__ import annotations

from typing import Sequence

import torch

from .tensor import matricize


def khatri_rao(matrices: Sequence[torch.Tensor]) -> torch.Tensor:
    """Column-wise Khatri-Rao product.

    ``matrices[k]`` is ``(I_k, R)``; the result is ``(prod I_k, R)`` with
    the *first* matrix's index varying fastest, so that
    ``matricize(X, n) @ khatri_rao([A_k for k != n])`` is the MTTKRP.
    Leading batch axes broadcast: a ``(B, I_k, R)`` stack beside shared
    ``(I_k, R)`` matrices gives ``(B, prod I_k, R)``.
    """
    if len(matrices) == 0:
        raise ValueError("need at least one matrix")
    rank = matrices[0].shape[-1]
    for m in matrices:
        if m.shape[-1] != rank:
            raise ValueError("rank mismatch in khatri_rao")
    out = matrices[-1]
    for m in reversed(matrices[:-1]):
        # out: (.., J, R), m: (.., I, R) -> (.., J*I, R) with m's index fastest.
        out = out[..., :, None, :] * m[..., None, :, :]
        out = out.reshape(*out.shape[:-3], -1, rank)
    return out


def mttkrp_via_matmul(
    x: torch.Tensor, factors: Sequence[torch.Tensor | None], mode: int
) -> torch.Tensor:
    """The explicit-KRP matmul baseline: ``X_(n) @ KRP``."""
    k = khatri_rao([f for i, f in enumerate(factors) if i != mode])
    return matricize(x, mode) @ k
