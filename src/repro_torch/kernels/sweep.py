"""The fused CP-ALS sweep's opening pair on Hopper: the wrapper, its plain
version, and its launch count.

Source: ``csrc/sweep.cu`` (``fused_pair_mma_kernel<T, MT, NT>``). It
replaces the TPU kernel ``repro/kernels/sweep.py:mttkrp_fused_pair_pallas``
(``_fused_pair_kernel``): one pass over a mode-0-canonical
``X (I, C_1..C_{N-1})`` gives both

    B0(i, r)              = sum_c X(i, c..) prod_d A_d(c_d, r)
    P(i, c_1..c_{N-2}, r) = sum_{c_{N-1}} X(i, c..) A_{N-1}(c_{N-1}, r).

What bounds it on an H100: the bytes of X and P (4.26e9 B at 1000^3, R=64
in fp32, 1.27 ms at 3.35 TB/s; 4.95e9 B at 180^4, R=32, 1.48 ms); the
2|X|R products run on the tensor cores (3xTF32 for fp32: 0.78 ms at
1000^3). The kernel is the MTTKRP kernel (``csrc/mttkrp.cu``) on the same
``cp.async`` ring and tensor cores (``csrc/ring.cuh``), with two changes: a
CTA walks each leading index tuple's chunks of the last axis one after
another, so the tuple's P tile is whole in its registers, and when the
tuple is done it stores the P tile and adds it, scaled by the product of
the leading factors' rows, into the B0 accumulators in shared memory. The
tuples are split over CTAs, never one tuple over two, so P's tiles are
disjoint; B0's per-split slabs are added by ``splitk.splitk_reduce`` in a
fixed order. The plan is the MTTKRP kernel's type
(:class:`~repro_torch.engine.plan.MTTKRPKernelPlan`), chosen against the
pair's own shared memory (:func:`~repro_torch.engine.plan.choose_pair_kernel_blocks`).
Ragged edges are masked; nothing is padded.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from ..engine.plan import (
    MTTKRPKernelPlan,
    choose_pair_kernel_blocks,
    pair_kernel_grid,
    pair_kernel_smem_bytes,
)
from ..observe import collect
from .build import check, count_launch, launch_library, library
from .mttkrpn import mttkrpn_plain
from .splitk import (
    check_extents,
    check_operands,
    check_smem,
    copy_width,
    kernel_plan,
    splitk_reduce,
)


def fused_pair_plain(
    x: torch.Tensor, factors: Sequence[torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version in float32: ``P = X(-1, C_last) @ A_last`` reshaped,
    and ``B0 = mttkrpn_plain(X, factors)``."""
    rank = factors[-1].shape[1]
    p = x.float().reshape(-1, x.shape[-1]) @ factors[-1].float()
    return mttkrpn_plain(x, factors), p.reshape(tuple(x.shape[:-1]) + (rank,))


def smem_bytes(plan: MTTKRPKernelPlan, dtype: torch.dtype, ncontract: int) -> int:
    """The library's own count of the pair kernel's dynamic shared memory
    under ``plan`` with ``ncontract`` contraction axes (-1 for blocks it does
    not take); :func:`~repro_torch.engine.plan.pair_kernel_smem_bytes`
    mirrors it."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return int(library("sweep.cu").repro_fused_pair_smem_bytes(
        itemsize, ncontract, plan.block_i, plan.block_k, plan.block_r, plan.stages))


def fused_pair(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    *,
    plan: MTTKRPKernelPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B0, P)`` from one pass over a mode-0-canonical ``(I, C_1..C_{N-1})``
    tensor, N >= 3, with its N-1 factors in axis order; both float32, P of
    shape ``(I, C_1..C_{N-2}, R)``. A CUDA tensor launches the kernel under
    ``plan`` (default: :func:`choose_pair_kernel_blocks`; any other plan
    type raises ``TypeError``); a CPU tensor ignores ``plan`` and takes
    :func:`fused_pair_plain`."""
    if x.ndim < 3 or len(factors) != x.ndim - 1:
        raise ValueError(f"fused_pair: a tensor of 3 or more axes with one factor per "
                         f"contraction axis, got {tuple(x.shape)} and {len(factors)} factors")
    rank = factors[0].shape[1]
    if x.device.type == "cpu":
        return collect.stand_in(lambda: fused_pair_plain(x, factors),
                                lambda: _report_plain(x, factors, rank, plan))
    check_operands("fused_pair", x, factors, rank)
    check_extents("fused_pair", x.shape)
    plan = kernel_plan("fused_pair", x, rank, plan, choose=choose_pair_kernel_blocks)
    nc, itemsize = len(factors), x.element_size()
    check_smem("fused_pair", plan, pair_kernel_smem_bytes(plan, itemsize, nc))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    _, _, splits = pair_kernel_grid(x.shape, rank, plan, sms)
    i_sz = x.shape[0]
    b0 = torch.empty((i_sz, rank), device=x.device, dtype=torch.float32)
    ws = b0 if splits == 1 else torch.empty(
        (splits, i_sz, rank), device=x.device, dtype=torch.float32)
    p = torch.empty(tuple(x.shape[:-1]) + (rank,), device=x.device, dtype=torch.float32)
    ptrs = [f.data_ptr() for f in factors]
    copy_x = copy_width(x.shape[-1] * itemsize, [x.data_ptr()])
    copy_f = copy_width(rank * itemsize, ptrs)
    lib = launch_library("sweep.cu", ws, p)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_fused_pair(
            0 if x.dtype == torch.float32 else 1, nc, (ctypes.c_longlong * (nc + 1))(*x.shape),
            plan.block_i, plan.block_k, plan.block_r, plan.stages, rank, splits, copy_x, copy_f,
            x.data_ptr(), (ctypes.c_longlong * nc)(*ptrs), ws.data_ptr(), p.data_ptr(), stream)
    check(err, "fused_pair")
    count_launch(fused_pair)
    if collect.SINKS:
        collect.report("fused_pair", plan, collect.nbytes(x, *factors),
                       collect.nbytes(ws, p) if splits > 1 else collect.nbytes(b0, p),
                       collect.dtype_name(ws))
    if splits > 1:
        splitk_reduce(ws, b0)
    return b0, p


fused_pair.launches = 0  # type: ignore[attr-defined]


def _report_plain(x: torch.Tensor, factors, rank: int, plan) -> None:
    """The launches :func:`fused_pair` would make on an H100 for a CPU
    ``x`` (:mod:`repro_torch.observe.collect`)."""
    if not isinstance(plan, MTTKRPKernelPlan):
        plan = choose_pair_kernel_blocks(tuple(x.shape), rank, x.element_size())
    splits = pair_kernel_grid(x.shape, rank, plan)[2]
    collect.report_split("fused_pair", plan, collect.nbytes(x, *factors), x.shape[0] * rank * 4,
                         splits, other_written=math.prod(x.shape[:-1]) * rank * 4)


def fused_pair_canonical(
    x: torch.Tensor,
    fs: Sequence[torch.Tensor],
    *,
    plan: MTTKRPKernelPlan | None = None,
    out_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of ``repro.kernels.sweep.fused_pair_canonical_pallas``:
    ``x`` has the output mode at axis 0, ``fs`` are the N-1 factors for
    axes 1..N-1, cast to ``x``'s dtype. Nothing is padded (the kernel
    masks). Returns ``(b0, p)``, cast to ``out_dtype`` when given."""
    x = x.contiguous()
    fs = [f.to(x.dtype).contiguous() for f in fs]
    b0, p = fused_pair(x, fs, plan=plan)
    if out_dtype is not None:
        return b0.to(out_dtype), p.to(out_dtype)
    return b0, p
