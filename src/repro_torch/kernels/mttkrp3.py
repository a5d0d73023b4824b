"""3-way MTTKRP on Hopper: the wrapper, its plain version, and its launch
count.

Source: ``csrc/mttkrp.cu`` (``mttkrp_mma_kernel<T, 2, MT, NT>``). It
replaces the TPU kernel ``repro/kernels/mttkrp3.py:mttkrp3_pallas``
(``_mttkrp3_kernel``): the canonical mode-0 contraction
O(i, r) = sum_jk X(i, j, k) A(j, r) B(k, r) against the Khatri-Rao
product W[(j, k), r] = A(j, r) B(k, r) (k fastest), which never exists in
device memory.

What bounds it on an H100: reading X once. At 1000^3, R=64 that is
4.0e9 B at 3.35 TB/s (1.19 ms) for fp32 X and half that for bf16 X; the
2 I J K R = 1.28e11 FLOP run on the tensor cores, as three TF32 products
each for fp32 X (0.78 ms at 495 TFLOP/s). The design treats X as an
(I, J K) matrix streamed once through a ``cp.async`` ring in shared
memory, in chunks of consecutive k under one j. Within such a chunk
W(j, k, r) = A(j, r) B(k, r), so no Khatri-Rao block is built: ``mma.sync``
multiplies the chunk of X by B's rows (3xTF32 for fp32 X; bf16 against the
exact bf16 factor for bf16 X) into an fp32 partial, which is scaled by
A(j, r) as it is added to the fp32 accumulators. K is split over CTAs to
fill the SMs and ``splitk.splitk_reduce`` adds the splits in a fixed order.
Ragged edges are zero-filled by the copies, so X is never padded. The
header of ``csrc/mttkrp.cu`` gives the details; the plan is the kernel's
own (:class:`~..engine.plan.MTTKRPKernelPlan`).
"""

from __future__ import annotations

import torch

from ..core.krp import khatri_rao
from ..engine.plan import MTTKRPKernelPlan
from ..observe import collect
from .build import count_launch
from .splitk import launch_tile, report_tile_plain


def mttkrp3_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: ``X(I, J*K) @ KRP`` in float32, KRP row index j*K + k;
    for a batch ``(B, I, J, K)`` the same for each element, against its
    ``(B, J, R)`` factors or the shared ``(J, R)`` ones."""
    w = khatri_rao([b.float(), a.float()])  # the first matrix's index fastest
    return x.float().reshape(*x.shape[:-2], -1) @ w


def mttkrp3(
    x: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    plan: MTTKRPKernelPlan | None = None,
) -> torch.Tensor:
    """Canonical mode-0 3-way MTTKRP: O(i,r) = sum_jk X(i,j,k) A(j,r) B(k,r).

    Unpadded inputs of any extent; returns float32 ``(I, R)``. A batch
    ``(B, I, J, K)``, with ``(B, J, R)`` / ``(B, K, R)`` factors or shared
    ``(J, R)`` / ``(K, R)`` ones, returns ``(B, I, R)`` from one launch. A
    CUDA tensor launches the kernel under ``plan`` (default:
    ``choose_mttkrp_kernel_blocks`` for one element; any other plan type
    raises ``TypeError``); a CPU tensor ignores ``plan`` and takes
    :func:`mttkrp3_plain`."""
    if x.ndim not in (3, 4):
        raise ValueError(f"mttkrp3: a 3-way tensor or a batch of them, got {x.ndim}-way")
    if x.device.type == "cpu":
        return collect.stand_in(lambda: mttkrp3_plain(x, a, b),
                                lambda: report_tile_plain("mttkrp3", x, [a, b], plan))
    out = launch_tile(x, [a, b], plan, specialized=True, name="mttkrp3")
    count_launch(mttkrp3)
    return out


mttkrp3.launches = 0  # type: ignore[attr-defined]
