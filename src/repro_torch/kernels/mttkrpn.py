"""Blocked N-way MTTKRP on Hopper: the wrapper, its plain version, and its
launch count.

Source: ``csrc/mttkrp.cu`` (``mttkrp_tile_kernel<T, RC, 0>``). It replaces
the TPU kernel ``repro/kernels/mttkrpn.py:mttkrpn_pallas`` (``_kernel``):
the canonical mode-0 contraction of an ``(I, C_1..C_{N-1})`` tensor with the
chained Khatri-Rao weight W[(c_1..c_{N-1}), r] = prod_d A_d(c_d, r), built
on chip with the last index fastest. It serves N >= 4, the 3-way
``variant="generic"``, and the dimension tree's 2-D edge (one contraction
axis: X as an ``(I_1 I_2, I_0)`` matrix).

What bounds it on an H100: at 180^4, R=32 (fp32) reading X once
(4.2e9 B at 3.35 TB/s, 1.25 ms) outweighs the arithmetic (6.7e10 FLOP at
67 TFLOP/s, 1.00 ms). The design is that of ``mttkrp3``: the contraction
loop inside the CTA, the outermost contraction axis split over CTAs and
reduced in a fixed order, tiles staged in shared memory, fp32 FMAs, ragged
edges masked in the kernel. W is built per step from one prefix product per
leading index tuple times the last factor tile. The rank-augmented partial
kernel (``mttkrp_partial_pallas``) is :mod:`.partial`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.krp import khatri_rao
from ..engine.plan import BlockPlan, Memory, choose_blocks
from .splitk import launch_tile


def mttkrpn_plain(x: torch.Tensor, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version: ``X(I, prod C) @ KRP`` in float32, the last factor's
    index fastest (C-order over the contraction axes)."""
    w = khatri_rao([f.float() for f in reversed(factors)])
    return x.float().reshape(x.shape[0], -1) @ w


def mttkrpn(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    *,
    plan: BlockPlan | None = None,
) -> torch.Tensor:
    """Canonical mode-0 N-way MTTKRP. ``factors`` are the N-1 non-output
    factors in tensor-axis order (axes 1..N-1). Unpadded inputs; returns
    float32 ``(I, R)``. A CUDA tensor launches the kernel under ``plan``
    (default: planned against ``Memory.h100_smem()``); a CPU tensor takes
    :func:`mttkrpn_plain`."""
    if len(factors) != x.ndim - 1:
        raise ValueError(f"mttkrpn: {x.ndim}-way tensor with {len(factors)} factors")
    if x.device.type == "cpu":
        return mttkrpn_plain(x, factors)
    if plan is None:
        plan = choose_blocks(
            x.shape, factors[0].shape[1], memory=Memory.h100_smem(itemsize=x.element_size())
        )
    out = launch_tile(x, factors, plan, specialized=False, name="mttkrpn")
    mttkrpn.launches += 1
    return out


mttkrpn.launches = 0  # type: ignore[attr-defined]
