"""Plain oracles for the MTTKRP kernels, accumulating in float32.
Counterpart of ``repro.kernels.ref``."""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.mttkrp import einsum_spec


def mttkrp_ref(
    x: torch.Tensor, factors: Sequence[torch.Tensor | None], mode: int
) -> torch.Tensor:
    """Reference MTTKRP: one einsum on float32 operands; ``factors[mode]``
    is ignored. The output is float32, as the kernels' is."""
    ins = [f.float() for k, f in enumerate(factors) if k != mode]
    return torch.einsum(einsum_spec(x.ndim, mode), x.float(), *ins)


def mttkrp3_ref(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Canonical mode-0 3-way oracle: O(i,r) = sum_jk X(i,j,k) A(j,r) B(k,r)."""
    return mttkrp_ref(x, [None, a, b], 0)
