"""The kept-mode Multi-TTM on Hopper: the wrapper, its plain version, and
its launch count.

Source: ``csrc/multi_ttm.cu`` (``multi_ttm_kernel<T>``). It replaces the TPU
kernel ``repro/kernels/multi_ttm.py:multi_ttm_keep_pallas`` (``_kernel``),
the Tucker/HOOI workhorse: for a kept-mode-first ``X (I, C_1..C_k)`` and k
matrices ``A_d (C_d, R_d)``,

    O(i, r_1..r_k) = sum_c X(i, c_1..c_k) prod_d A_d(c_d, r_d),

an fp32 ``(I, prod R_d)`` output, columns in C order over ``(r_1..r_k)``.

What bounds it on an H100: reading X once (a 1000^3 fp32 tensor is 4.0e9 B,
1.19 ms at 3.35 TB/s). The TPU kernel builds the full Kronecker weight and
does ``2 |X| prod R_d`` operations (2.05e12 at 1000^3 with ranks (32, 32),
31 ms of fp32 FMAs); the CUDA kernel contracts the modes one after another
inside the CTA, ``c_k`` first against X as it streams in, then the leading
axes in shared memory, about ``2 |X| R_k`` operations (6.6e10 there, 1.0
ms). X is read once; the output tile stays in shared memory across the
CTA's steps; the ``c_1`` tiles are split over CTAs and the slabs added by
:func:`.splitk.splitk_reduce` in a fixed order. Ragged edges are masked;
nothing is padded. The wrapper plans against the kernel's real shared
memory (:func:`~repro_torch.engine.plan.choose_multi_ttm_kernel_blocks`)
and checks the library's own count against one CTA's limit.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from ..engine.plan import MultiTTMPlan, choose_multi_ttm_kernel_blocks
from .build import check, library
from .splitk import check_smem, n_splits, splitk_reduce


def multi_ttm_keep_plain(x: torch.Tensor, matrices: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version: a float32 chain of ``torch.tensordot``, the last axis
    first; returns ``(I, prod R_d)``."""
    out = x.float()
    k = len(matrices)
    for d in range(k, 0, -1):  # out is (I, C_1..C_d, R_{d+1}..R_k)
        out = torch.tensordot(out, matrices[d - 1].float(), dims=([d], [0])).movedim(-1, d)
    return out.reshape(x.shape[0], -1)


def smem_bytes(plan: MultiTTMPlan, dtype: torch.dtype) -> int:
    """Dynamic shared memory the kernel takes under ``plan``, from the
    library's own layout."""
    k = len(plan.block_contract)
    bc = (ctypes.c_int * k)(*plan.block_contract)
    ranks = (ctypes.c_int * k)(*plan.ranks)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return int(library("multi_ttm.cu").repro_multi_ttm_smem_bytes(
        itemsize, k, bc, plan.block_i, ranks))


def _check_operands(x: torch.Tensor, matrices: Sequence[torch.Tensor],
                    plan: MultiTTMPlan) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"multi_ttm_keep: the kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"multi_ttm_keep: float32 or bfloat16 input, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("multi_ttm_keep: the tensor must be contiguous")
    for d, m in enumerate(matrices):
        if m.device != x.device or m.dtype != x.dtype or not m.is_contiguous():
            raise ValueError(
                f"multi_ttm_keep: matrix {d} must be a contiguous {x.dtype} tensor on {x.device}"
            )
    ranks = tuple(m.shape[1] for m in matrices)
    if len(plan.block_contract) != len(matrices) or tuple(plan.ranks) != ranks:
        raise ValueError(f"multi_ttm_keep: plan {plan} does not fit operand "
                         f"{tuple(x.shape)} with ranks {ranks}")


def multi_ttm_keep(
    x: torch.Tensor,
    matrices: Sequence[torch.Tensor],
    *,
    plan: MultiTTMPlan | None = None,
) -> torch.Tensor:
    """Canonical kept-mode-first Multi-TTM of an ``(I, C_1..C_k)`` tensor
    with its k ``(C_d, R_d)`` matrices, k >= 1; returns float32
    ``(I, prod R_d)``. A CUDA tensor launches the kernel under ``plan``
    (default: :func:`choose_multi_ttm_kernel_blocks`); a CPU tensor takes
    :func:`multi_ttm_keep_plain`."""
    k = len(matrices)
    if x.ndim != k + 1 or k < 1 or k > 7:
        raise ValueError(f"multi_ttm_keep: tensor of shape {tuple(x.shape)} with {k} matrices")
    for d, m in enumerate(matrices):
        if m.ndim != 2 or m.shape[0] != x.shape[1 + d]:
            raise ValueError(f"multi_ttm_keep: matrix {d} has shape {tuple(m.shape)}, "
                             f"expected ({x.shape[1 + d]}, R_{d + 1})")
    if x.device.type == "cpu":
        return multi_ttm_keep_plain(x, matrices)
    ranks = tuple(m.shape[1] for m in matrices)
    if plan is None:
        plan = choose_multi_ttm_kernel_blocks(x.shape, ranks, x.element_size())
    _check_operands(x, matrices, plan)
    lib = library("multi_ttm.cu")
    check_smem("multi_ttm_keep", plan, smem_bytes(plan, x.dtype))
    i_sz, prod_r = x.shape[0], math.prod(ranks)
    outer = math.ceil(x.shape[1] / plan.block_contract[0])
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = n_splits(math.ceil(i_sz / plan.block_i), outer, sms)
    out = torch.empty((i_sz, prod_r), device=x.device, dtype=torch.float32)
    ws = out if splits == 1 else torch.empty(
        (splits, i_sz, prod_r), device=x.device, dtype=torch.float32)
    extents = (ctypes.c_longlong * (k + 1))(*x.shape)
    blocks = (ctypes.c_int * (k + 1))(plan.block_i, *plan.block_contract)
    c_ranks = (ctypes.c_int * k)(*ranks)
    ptrs = (ctypes.c_longlong * k)(*(m.data_ptr() for m in matrices))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_multi_ttm(0 if x.dtype == torch.float32 else 1, k, extents, blocks,
                                  c_ranks, splits, x.data_ptr(), ptrs, ws.data_ptr(), stream)
    check(err, "multi_ttm_keep")
    multi_ttm_keep.launches += 1
    if splits > 1:
        splitk_reduce(ws, out)
    return out


multi_ttm_keep.launches = 0  # type: ignore[attr-defined]
