"""Blocked 3-way MTTKRP on Hopper: the wrapper, its plain version, and its
launch count.

Source: ``csrc/mttkrp.cu`` (``mttkrp_tile_kernel<T, RC, 2>``). It replaces
the TPU kernel ``repro/kernels/mttkrp3.py:mttkrp3_pallas``
(``_mttkrp3_kernel``): the canonical mode-0 contraction
O(i, r) = sum_jk X(i, j, k) A(j, r) B(k, r), with the Khatri-Rao block
W[(j, k), r] = A(j, r) B(k, r) built on chip (k fastest) and never in
device memory.

What bounds it on an H100: at 1000^3, R=64 the fp32 arithmetic
(2 I R = 1.28e11 FLOP at 67 TFLOP/s, 1.91 ms) outweighs reading X once
(4.0e9 B at 3.35 TB/s, 1.19 ms); bf16 X is bound by its bytes (0.60 ms).
The design answers with fp32 FMAs from shared memory: each staged X element
feeds the CTA's br rank columns, each W element its bi rows; the contraction
loop runs inside the CTA, the outermost contraction axis is split over CTAs
to fill the SMs, and ``splitk.splitk_reduce`` adds the splits in a fixed
order. Ragged edges are masked in the kernel, so X is never padded.
"""

from __future__ import annotations

import torch

from ..core.krp import khatri_rao
from ..engine.plan import BlockPlan, Memory, choose_blocks
from .splitk import launch_tile


def mttkrp3_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: ``X(I, J*K) @ KRP`` in float32, KRP row index j*K + k."""
    w = khatri_rao([b.float(), a.float()])  # the first matrix's index fastest
    return x.float().reshape(x.shape[0], -1) @ w


def mttkrp3(
    x: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    plan: BlockPlan | None = None,
) -> torch.Tensor:
    """Canonical mode-0 3-way MTTKRP: O(i,r) = sum_jk X(i,j,k) A(j,r) B(k,r).

    Unpadded inputs of any extent; returns float32 ``(I, R)``. A CUDA tensor
    launches the kernel under ``plan`` (default: planned against
    ``Memory.h100_smem()``); a CPU tensor takes :func:`mttkrp3_plain`."""
    if x.ndim != 3:
        raise ValueError(f"mttkrp3: a 3-way tensor, got {x.ndim}-way")
    if x.device.type == "cpu":
        return mttkrp3_plain(x, a, b)
    if plan is None:
        plan = choose_blocks(
            x.shape, a.shape[1], memory=Memory.h100_smem(itemsize=x.element_size())
        )
    out = launch_tile(x, [a, b], plan, specialized=True, name="mttkrp3")
    mttkrp3.launches += 1
    return out


mttkrp3.launches = 0  # type: ignore[attr-defined]
