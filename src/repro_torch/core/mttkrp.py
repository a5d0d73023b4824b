"""Local (single-device) MTTKRP implementations (PyTorch).

Definition 2.1 of the paper:

    B^(n)(i_n, r) = sum_{i : i[n] = i_n} X(i) * prod_{k != n} A^(k)(i_k, r)

``mttkrp_naive`` keeps the N-ary multiplies atomic (the paper's arithmetic
model); ``mttkrp`` is the einsum path. Counterpart of ``repro.core.mttkrp``.
"""

from __future__ import annotations

from typing import Sequence

import torch

_LETTERS = "abcdefghijklmnopqrstuvw"


def einsum_spec(ndim: int, mode: int) -> str:
    """e.g. ndim=3, mode=1 -> 'abc,az,cz->bz'."""
    ins = [_LETTERS[:ndim]]
    for k in range(ndim):
        if k != mode:
            ins.append(f"{_LETTERS[k]}z")
    return ",".join(ins) + f"->{_LETTERS[mode]}z"


def mttkrp(
    x: torch.Tensor, factors: Sequence[torch.Tensor | None], mode: int
) -> torch.Tensor:
    """MTTKRP via a single einsum contraction; ``factors[mode]`` is ignored
    (may be ``None``). Returns ``B^(mode)`` of shape ``(I_mode, R)``."""
    ndim = x.ndim
    if not 0 <= mode < ndim:
        raise ValueError(f"mode {mode} out of range")
    ins = [f for k, f in enumerate(factors) if k != mode]
    return torch.einsum(einsum_spec(ndim, mode), x, *ins)


def mttkrp_naive(
    x: torch.Tensor, factors: Sequence[torch.Tensor | None], mode: int
) -> torch.Tensor:
    """Atomic N-ary-multiply MTTKRP: per rank column, every loop iteration
    performs one N-ary product (no factoring through the sums). Oracle only."""
    ndim = x.ndim
    rank = next(f.shape[1] for k, f in enumerate(factors) if k != mode)
    axes = tuple(k for k in range(ndim) if k != mode)
    cols = []
    for r in range(rank):
        prod = x
        for k in axes:
            shape = [1] * ndim
            shape[k] = x.shape[k]
            prod = prod * factors[k][:, r].reshape(shape)
        cols.append(prod.sum(dim=axes))
    return torch.stack(cols, dim=1)


def mttkrp_all_modes(
    x: torch.Tensor, factors: Sequence[torch.Tensor]
) -> list[torch.Tensor]:
    """MTTKRP in every mode (the CP-ALS inner loop), no reuse."""
    return [mttkrp(x, factors, n) for n in range(x.ndim)]
