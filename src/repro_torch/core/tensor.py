"""Dense tensor utilities shared by the MTTKRP/CP core (PyTorch).

Counterpart of ``repro.core.tensor``; the same conventions hold:

* An ``N``-way tensor is a ``torch.Tensor`` of shape ``(I_1, ..., I_N)``.
* Factor matrices ``A^(k)`` have shape ``(I_k, R)``.
* ``mode`` indices are 0-based (the paper is 1-based).
* Matricization ``X_(n)`` follows the Kolda/Bader convention: the remaining
  modes ``(0, ..., n-1, n+1, ..., N-1)`` vary earliest-fastest.

The random constructors take an explicit ``torch.Generator``: JAX's PRNG
cannot be reproduced, so tests that compare the two packages make their
inputs with numpy and hand the same arrays to both.
"""

from __future__ import annotations

import math
from functools import reduce
from typing import Sequence

import numpy as np
import torch

_LETTERS = "abcdefghijklmnopqrstuvw"


def matricize(x: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode-``mode`` matricization ``X_(n)`` of shape ``(I_n, I/I_n)``
    (Kolda/Bader column order: the earliest remaining mode is fastest)."""
    n = x.ndim
    if not 0 <= mode < n:
        raise ValueError(f"mode {mode} out of range for {n}-way tensor")
    rest = tuple(k for k in range(n) if k != mode)
    # Fortran order over the remaining axes == reversed axes, C-ravel.
    return x.permute((mode,) + rest[::-1]).reshape(x.shape[mode], -1)


def dematricize(xm: torch.Tensor, mode: int, shape: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`matricize`: the ``shape`` tensor whose mode-``mode``
    matricization is ``xm``."""
    shape = tuple(shape)
    n = len(shape)
    rest = tuple(k for k in range(n) if k != mode)
    # matricize produced axes (mode, reversed(rest))
    xt = xm.reshape((shape[mode],) + tuple(shape[k] for k in reversed(rest)))
    xt = xt.permute((0,) + tuple(range(n - 1, 0, -1)))  # now (mode,) + rest
    inv = [0] * n
    for pos, axis in enumerate((mode,) + rest):
        inv[axis] = pos
    return xt.permute(inv)


def tensor_from_factors(
    factors: Sequence[torch.Tensor], weights: torch.Tensor | None = None
) -> torch.Tensor:
    """The full tensor of a CP model: the sum of its rank-1 outer products.

    ``factors[k]`` is ``(I_k, R)``; ``weights`` (λ, shape ``(R,)``) scales
    each rank-1 term once."""
    n = len(factors)
    if n < 2:
        raise ValueError("need at least 2 factors")
    subs = [f"{_LETTERS[k]}z" for k in range(n)]
    ops = list(factors)
    if weights is not None:
        subs.append("z")
        ops.append(weights)
    return torch.einsum(",".join(subs) + "->" + _LETTERS[:n], *ops)


def frob_norm(x: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of ``x`` cast to float32, as the reference takes it for
    every input dtype: a float64 tensor is rounded to float32 first; a
    narrower one is widened inside the reduction (no float32 copy)."""
    if x.dtype == torch.float64:
        x = x.float()
    return torch.linalg.vector_norm(x.reshape(-1), dtype=torch.float32)


def relative_error(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``||x - y|| / ||x||`` in float32 (a zero ``x`` counts as 1e-30)."""
    return frob_norm(x - y) / torch.clamp(frob_norm(x), min=1e-30)


def total_size(dims: Sequence[int]) -> int:
    """I = prod(I_k)."""
    return int(reduce(lambda a, b: a * b, dims, 1))


def random_tensor(
    generator: torch.Generator,
    dims: Sequence[int],
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """A standard-normal tensor of shape ``dims`` on the generator's device."""
    return torch.randn(tuple(dims), generator=generator, device=generator.device, dtype=dtype)


def random_factors(
    generator: torch.Generator,
    dims: Sequence[int],
    rank: int,
    dtype: torch.dtype = torch.float32,
) -> list[torch.Tensor]:
    """Standard-normal factors scaled by ``1/sqrt(rank)``, on the
    generator's device."""
    return [
        torch.randn(
            (d, rank), generator=generator, device=generator.device,
            dtype=dtype,
        ) / math.sqrt(rank)
        for d in dims
    ]


def random_low_rank_tensor(
    generator: torch.Generator,
    dims: Sequence[int],
    rank: int,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """An exactly rank-``rank`` tensor together with its generating factors."""
    factors = random_factors(generator, dims, rank, dtype)
    return tensor_from_factors(factors), factors


def random_tucker_tensor(
    generator: torch.Generator,
    dims: Sequence[int],
    ranks: Sequence[int],
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, list[torch.Tensor]]:
    """An exact multilinear-rank-``ranks`` tensor ``G x_1 A_1 ... x_N A_N``
    with a standard-normal core and orthonormal factors (``torch.linalg.qr``
    of standard-normal matrices), on the generator's device; returns
    ``(tensor, core, factors)``."""
    dev = generator.device
    core = torch.randn(tuple(ranks), generator=generator, device=dev, dtype=dtype)
    factors = []
    for d, r in zip(dims, ranks):
        q, _ = torch.linalg.qr(torch.randn((d, r), generator=generator, device=dev, dtype=dtype))
        factors.append(q)
    out = core
    for k, a in enumerate(factors):
        out = torch.tensordot(out, a, dims=([k], [1])).movedim(-1, k)
    return out, core, factors


def np_matricize(x: np.ndarray, mode: int) -> np.ndarray:
    """NumPy twin of :func:`matricize` (the sequential simulator's), a copy
    of ``repro.core.tensor.np_matricize``."""
    n = x.ndim
    perm = (mode,) + tuple(k for k in range(n) if k != mode)
    return np.transpose(x, perm).reshape(x.shape[mode], -1, order="F")
