"""The kept-mode Multi-TTM on Hopper: the wrapper, its plain version, and
its launch count.

Source: ``csrc/multi_ttm.cu`` (``multi_ttm_mma_kernel<T, MT, NT>``). It
replaces the TPU kernel ``repro/kernels/multi_ttm.py:multi_ttm_keep_pallas``
(``_kernel``), the Tucker/HOOI workhorse: for a kept-mode-first
``X (I, C_1..C_k)`` and k matrices ``A_d (C_d, R_d)``,

    O(i, r_1..r_k) = sum_c X(i, c_1..c_k) prod_d A_d(c_d, r_d),

an fp32 ``(I, prod R_d)`` output, columns in C order over ``(r_1..r_k)``.

What bounds it on an H100: reading X once (a 1000^3 fp32 tensor is 4.0e9 B,
1.19 ms at 3.35 TB/s). The TPU kernel builds the full Kronecker weight and
does ``2 |X| prod R_d`` operations; the CUDA kernel contracts the modes one
after another and never forms it. X is the row-major matrix of rows
``(i, c_1..c_{k-1})`` by ``C_k``; a tile of consecutive ``c_{k-1}`` rows
streams through the ``cp.async`` ring of ``csrc/ring.cuh`` and is multiplied
by ``A_k`` on the tensor cores (``2 |X| R_k`` operations, 3xTF32 for fp32);
each finished tile is folded into the output tile of its i in shared
memory, through ``A_{k-1}`` and the outer weights, on the CUDA cores. The
tiles of one i are split over CTAs and the slabs added by
:func:`.splitk.splitk_reduce` in a fixed order. Ragged edges are masked;
nothing is padded. The kernel has its own plan
(:class:`~repro_torch.engine.plan.MultiTTMKernelPlan`, default
:func:`~repro_torch.engine.plan.choose_multi_ttm_kernel_blocks` against its
real shared memory); a reference-shaped ``MultiTTMPlan`` raises
``TypeError`` on a CUDA tensor. A batch of B problems of one shape (``X``
with a leading batch axis) is one launch, the batch the grid's z dimension.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from ..engine.plan import (
    H100_SMS,
    MultiTTMKernelPlan,
    choose_multi_ttm_kernel_blocks,
    multi_ttm_kernel_grid,
    multi_ttm_kernel_smem_bytes,
)
from ..observe import collect
from .build import check, count_launch, launch_library, library
from .splitk import (
    batch_stride,
    check_batch,
    check_extents,
    check_smem,
    copy_width,
    kernel_plan,
    splitk_reduce,
)


def multi_ttm_keep_plain(x: torch.Tensor, matrices: Sequence[torch.Tensor],
                         batched: bool = False) -> torch.Tensor:
    """Plain version: a float32 chain of ``torch.tensordot``, the last axis
    first; returns ``(I, prod R_d)``. ``batched``: ``x`` is a batch ``(B, I,
    C_1..C_k)``, a ``(B, C_d, R_d)`` matrix applied to each element by
    ``torch.bmm``, a shared ``(C_d, R_d)`` one by ``tensordot``; returns
    ``(B, I, prod R_d)``."""
    out = x.float()
    k, lead = len(matrices), int(batched)
    for d in range(k, 0, -1):  # out is ([B,] I, C_1..C_d, R_{d+1}..R_k)
        m, ax = matrices[d - 1].float(), lead + d
        if m.ndim == 2:
            out = torch.tensordot(out, m, dims=([ax], [0])).movedim(-1, ax)
        else:
            o = out.movedim(ax, -1)
            rest = o.shape[:-1]
            o = torch.bmm(o.reshape(rest[0], -1, o.shape[-1]), m)
            out = o.reshape(*rest, m.shape[-1]).movedim(-1, ax)
    return out.reshape(*x.shape[:lead + 1], -1)


def smem_bytes(plan: MultiTTMKernelPlan, dtype: torch.dtype, ranks: Sequence[int]) -> int:
    """The library's own count of the kernel's dynamic shared memory under
    ``plan`` for ranks ``R_1..R_k`` (-1 for blocks it does not take);
    :func:`~repro_torch.engine.plan.multi_ttm_kernel_smem_bytes` mirrors it."""
    k = len(ranks)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return int(library("multi_ttm.cu").repro_multi_ttm_smem_bytes(
        itemsize, k, (ctypes.c_int * k)(*ranks), plan.block_m, plan.block_k, plan.block_r,
        plan.stages))


def _check_operands(x: torch.Tensor, matrices: Sequence[torch.Tensor], batched: bool) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"multi_ttm_keep: the kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"multi_ttm_keep: float32 or bfloat16 input, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("multi_ttm_keep: the tensor must be contiguous")
    if batched:
        check_batch("multi_ttm_keep", x.shape[0])
    for d, m in enumerate(matrices):
        if m.device != x.device or m.dtype != x.dtype or not m.is_contiguous():
            raise ValueError(
                f"multi_ttm_keep: matrix {d} must be a contiguous {x.dtype} tensor on {x.device}"
            )


def multi_ttm_keep(
    x: torch.Tensor,
    matrices: Sequence[torch.Tensor],
    *,
    plan: MultiTTMKernelPlan | None = None,
    batched: bool = False,
) -> torch.Tensor:
    """Canonical kept-mode-first Multi-TTM of an ``(I, C_1..C_k)`` tensor
    with its k ``(C_d, R_d)`` matrices, k >= 1; returns float32
    ``(I, prod R_d)``. ``batched``: ``x`` is a batch ``(B, I, C_1..C_k)``,
    each matrix ``(B, C_d, R_d)`` or shared ``(C_d, R_d)``; one launch
    returns ``(B, I, prod R_d)``. A CUDA tensor launches the kernel under
    ``plan`` (default: :func:`choose_multi_ttm_kernel_blocks` for one
    element; any other plan type raises ``TypeError``); a CPU tensor ignores
    ``plan`` and takes :func:`multi_ttm_keep_plain`."""
    k = len(matrices)
    lead = int(batched)
    if x.ndim != k + 1 + lead or k < 1 or k > 7:
        raise ValueError(f"multi_ttm_keep: tensor of shape {tuple(x.shape)} with {k} matrices"
                         + (" (batched)" if batched else ""))
    for d, m in enumerate(matrices):
        rows = x.shape[lead + 1 + d]
        if not ((m.ndim == 2 and m.shape[0] == rows)
                or (batched and m.ndim == 3 and tuple(m.shape[:2]) == (x.shape[0], rows))):
            raise ValueError(f"multi_ttm_keep: matrix {d} has shape {tuple(m.shape)}, "
                             f"expected ({rows}, R_{d + 1})"
                             + (f" or ({x.shape[0]}, {rows}, R_{d + 1})" if batched else ""))
    if x.device.type == "cpu":
        return collect.stand_in(lambda: multi_ttm_keep_plain(x, matrices, batched),
                                lambda: _report_plain(x, matrices, plan, batched))
    _check_operands(x, matrices, batched)
    shape = tuple(x.shape[lead:])
    batch = x.shape[0] if batched else 1
    check_extents("multi_ttm_keep", shape)
    ranks = tuple(int(m.shape[-1]) for m in matrices)
    itemsize = x.element_size()
    plan = kernel_plan("multi_ttm_keep", x[0] if batched else x, ranks, plan,
                       choose=choose_multi_ttm_kernel_blocks, cls=MultiTTMKernelPlan)
    check_smem("multi_ttm_keep", plan, multi_ttm_kernel_smem_bytes(plan, itemsize, ranks))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    _, _, splits = multi_ttm_kernel_grid(shape, ranks, plan, sms, batch)
    i_sz, prod_r = shape[0], math.prod(ranks)
    out = torch.empty((batch, i_sz, prod_r), device=x.device, dtype=torch.float32)
    ws = out if splits == 1 else torch.empty(
        (splits, batch, i_sz, prod_r), device=x.device, dtype=torch.float32)
    ll = ctypes.c_longlong
    ptrs = [m.data_ptr() for m in matrices]
    x_bs = x.stride(0) if batched else 0
    m_bs = [batch_stride(m, 2) for m in matrices]
    copy_x = copy_width(shape[-1] * itemsize, [x.data_ptr()], [x_bs * itemsize])
    copy_f = copy_width(ranks[-1] * itemsize, [ptrs[-1]], [m_bs[-1] * itemsize])
    lib = launch_library("multi_ttm.cu", ws)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_multi_ttm(
            0 if x.dtype == torch.float32 else 1, k, (ll * (k + 1))(*shape),
            (ctypes.c_int * k)(*ranks), plan.block_m, plan.block_k, plan.block_r, plan.stages,
            splits, copy_x, copy_f, batch, x_bs, (ll * k)(*m_bs), x.data_ptr(),
            (ll * k)(*ptrs), ws.data_ptr(), stream)
    check(err, "multi_ttm_keep")
    count_launch(multi_ttm_keep)
    if collect.SINKS:
        collect.report("multi_ttm_keep", plan, collect.nbytes(x, *matrices), collect.nbytes(ws),
                       collect.dtype_name(ws))
    if splits > 1:
        splitk_reduce(ws, out)
    return out if batched else out[0]


multi_ttm_keep.launches = 0  # type: ignore[attr-defined]


def _report_plain(x: torch.Tensor, matrices, plan, batched: bool) -> None:
    """The launches :func:`multi_ttm_keep` would make on an H100 for a CPU
    ``x`` (:mod:`repro_torch.observe.collect`)."""
    shape = tuple(x.shape[int(batched):])
    batch = x.shape[0] if batched else 1
    ranks = tuple(int(m.shape[-1]) for m in matrices)
    if not isinstance(plan, MultiTTMKernelPlan):
        plan = choose_multi_ttm_kernel_blocks(shape, ranks, x.element_size())
    splits = multi_ttm_kernel_grid(shape, ranks, plan, H100_SMS, batch)[2]
    collect.report_split("multi_ttm_keep", plan, collect.nbytes(x, *matrices),
                         batch * shape[0] * math.prod(ranks) * 4, splits)
