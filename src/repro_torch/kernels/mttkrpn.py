"""N-way MTTKRP on Hopper: the wrapper, its plain version, and its launch
count.

Source: ``csrc/mttkrp.cu`` (``mttkrp_mma_kernel<T, 0, MT, NT>``). It
replaces the TPU kernel ``repro/kernels/mttkrpn.py:mttkrpn_pallas``
(``_kernel``): the canonical mode-0 contraction of an ``(I, C_1..C_{N-1})``
tensor with the chained Khatri-Rao weight W[(c_1..c_{N-1}), r] =
prod_d A_d(c_d, r) (the last index fastest), which never exists in device
memory. It serves N >= 4, the 3-way ``variant="generic"``, and the
dimension tree's 2-D edge (one contraction axis: X as an ``(I_1 I_2, I_0)``
matrix).

What bounds it on an H100: reading X once. At 180^4, R=32 (fp32) that is
4.2e9 B at 3.35 TB/s (1.25 ms), against 6.7e10 FLOP on the tensor cores
(three TF32 products each: 0.41 ms at 495 TFLOP/s). The kernel body is
``mttkrp3``'s with the number of contraction axes read at run time: X as
an (I, prod C) matrix through a ``cp.async`` ring, in chunks of the last
axis under one tuple of the leading indices; ``mma.sync`` multiplies each
chunk by the last factor's rows into an fp32 partial, which is scaled by
the product of the leading factors' rows of that tuple as it is added to
the accumulators; flat K is split over CTAs and reduced in a fixed order.
The rank-augmented partial kernel (``mttkrp_partial_pallas``) is
:mod:`.partial`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.krp import khatri_rao
from ..engine.plan import MTTKRPKernelPlan
from ..observe import collect
from .build import count_launch
from .splitk import launch_tile, report_tile_plain


def mttkrpn_plain(x: torch.Tensor, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version: ``X(I, prod C) @ KRP`` in float32, the last factor's
    index fastest (C-order over the contraction axes); for a batch (``x``
    with a leading axis more) the same for each element, against its
    ``(B, C_d, R)`` factors or the shared ``(C_d, R)`` ones."""
    w = khatri_rao([f.float() for f in reversed(factors)])
    lead = x.ndim - len(factors)  # (I,) or (B, I)
    return x.float().reshape(*x.shape[:lead], -1) @ w


def mttkrpn(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    *,
    plan: MTTKRPKernelPlan | None = None,
) -> torch.Tensor:
    """Canonical mode-0 N-way MTTKRP. ``factors`` are the N-1 non-output
    factors in tensor-axis order (axes 1..N-1). Unpadded inputs; returns
    float32 ``(I, R)``. An ``x`` with one axis more is a batch ``(B, I,
    C_1..C_{N-1})``, each factor ``(B, C_d, R)`` or shared ``(C_d, R)``:
    ``(B, I, R)`` from one launch. A CUDA tensor launches the kernel under
    ``plan`` (default: ``choose_mttkrp_kernel_blocks`` for one element; any
    other plan type raises ``TypeError``); a CPU tensor ignores ``plan`` and
    takes :func:`mttkrpn_plain`."""
    if len(factors) not in (x.ndim - 1, x.ndim - 2) or not factors:
        raise ValueError(f"mttkrpn: {x.ndim}-way tensor with {len(factors)} factors")
    if x.device.type == "cpu":
        return collect.stand_in(lambda: mttkrpn_plain(x, factors),
                                lambda: report_tile_plain("mttkrpn", x, factors, plan))
    out = launch_tile(x, factors, plan, specialized=False, name="mttkrpn")
    count_launch(mttkrpn)
    return out


mttkrpn.launches = 0  # type: ignore[attr-defined]
