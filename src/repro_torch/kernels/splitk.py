"""The split-contraction launch shared by the Hopper kernels, and the
deterministic reduction kernel that adds the splits.

Source: ``csrc/mttkrp.cu`` (``splitk_reduce_kernel``). It replaces what the
TPU kernels get from their sequential grid: the output tile stays resident
across the contraction steps (``repro/kernels/mttkrp3.py:67-69``). On
Hopper the CTAs run in parallel and in no order, so the contraction is split
over ``S`` CTAs (chunks of flat K for the MTTKRP kernel, leading tuples for
the pair, runs of contraction units for the partial kernel, ``c_1`` tiles
for Multi-TTM), each writing an fp32 slab of an
``(S, I, R)`` workspace, and this kernel sums the slabs in slab order: no
atomics, the same bits on every run. It moves ``(S + 1) * I * R * 4``
bytes and is bound by memory bandwidth. A batched launch of B problems
writes an ``(S, B, I, R)`` workspace, which one launch of this kernel
reduces, unchanged: it sees ``B I R`` outputs a slab.

The batch is the grid's z dimension in every batched kernel, so one launch
takes at most :data:`MAX_BATCH` problems; a larger batch raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from ..engine.plan import CTAS_PER_SM as CTAS_PER_SM  # re-exported with the split rule
from ..engine.plan import (
    H100_SMS,
    SMEM_PER_CTA_MAX,
    MTTKRPKernelPlan,
    choose_mttkrp_kernel_blocks,
    mttkrp_kernel_grid,
    mttkrp_kernel_smem_bytes,
)
from ..engine.plan import n_splits as n_splits  # re-exported: the split rule
from ..observe import collect
from .build import check, count_launch, launch_library, library


def splitk_reduce_plain(ws: torch.Tensor) -> torch.Tensor:
    """Plain version: the sum over the leading (split) axis."""
    return ws.sum(dim=0)


def splitk_reduce(ws: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out = ws.sum(0)`` for an fp32 ``(S, ...)`` workspace (``(S, I, R)``,
    or ``(S, B, I, R)`` for a batch), in slab order. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel."""
    if ws.device.type == "cpu":
        collect.stand_in(lambda: out.copy_(splitk_reduce_plain(ws)),
                          lambda: collect.report("splitk_reduce", None, collect.nbytes(ws),
                                                  collect.nbytes(out)))
        return out
    if ws.device.type != "cuda" or out.device != ws.device:
        raise ValueError(f"splitk_reduce: needs CUDA tensors, got {ws.device}, {out.device}")
    if ws.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError("splitk_reduce: workspace and output must be float32")
    if ws.ndim < 2 or tuple(out.shape) != tuple(ws.shape[1:]):
        raise ValueError(f"splitk_reduce: shapes {tuple(ws.shape)} -> {tuple(out.shape)}")
    if not (ws.is_contiguous() and out.is_contiguous()):
        raise ValueError("splitk_reduce: tensors must be contiguous")
    lib = launch_library("mttkrp.cu", out)
    with torch.cuda.device(ws.device):
        stream = torch.cuda.current_stream(ws.device).cuda_stream
        err = lib.repro_splitk_reduce(
            ws.data_ptr(), out.data_ptr(), out.numel(), ws.shape[0], stream
        )
    check(err, "splitk_reduce")
    count_launch(splitk_reduce)
    if collect.SINKS:
        collect.report("splitk_reduce", None, collect.nbytes(ws), collect.nbytes(out),
                       collect.dtype_name(out))
    return out


splitk_reduce.launches = 0  # type: ignore[attr-defined]


def smem_bytes(plan: MTTKRPKernelPlan, dtype: torch.dtype, ncontract: int) -> int:
    """The library's own count of the MTTKRP kernel's dynamic shared memory
    under ``plan`` with ``ncontract`` contraction axes (-1 for blocks it does
    not take); :func:`~..engine.plan.mttkrp_kernel_smem_bytes` mirrors it."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return int(library().repro_mttkrp_smem_bytes(
        itemsize, ncontract, plan.block_i, plan.block_k, plan.block_r, plan.stages))


#: Problems one batched launch takes: the batch is the grid's z dimension,
#: and ``gridDim.z`` stops at 65535 (``csrc/common.cuh:MAX_BATCH``).
MAX_BATCH = 65535


def check_batch(name: str, batch: int) -> None:
    """Raise unless one launch takes a batch of ``batch`` problems."""
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"{name}: a batch of {batch} problems; one launch takes 1 to "
                         f"{MAX_BATCH} (the batch is the grid's z dimension, gridDim.z)")


def batch_stride(t: torch.Tensor, elem_ndim: int) -> int:
    """Elements from one batch element of ``t`` to the next: ``t.stride(0)``
    for a stack with a leading batch axis (``elem_ndim + 1`` axes), 0 for an
    operand of ``elem_ndim`` axes that the whole batch shares."""
    return t.stride(0) if t.ndim == elem_ndim + 1 else 0


def check_operands(name: str, x: torch.Tensor, factors: Sequence[torch.Tensor],
                   rank: int, *, batched: bool = False) -> None:
    """Raise unless ``x`` is a contiguous fp32 or bf16 CUDA tensor whose axes
    1..k match the k contiguous ``(C_d, R)`` factors of its dtype and
    device. ``batched``: ``x`` carries a leading batch axis of B problems,
    and each factor is ``(B, C_d, R)`` (one an element) or ``(C_d, R)``
    (shared by the batch)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: float32 or bfloat16 input, got {x.dtype}")
    lead = int(batched)
    k = x.ndim - 1 - lead
    if len(factors) != k or not 1 <= k <= 7:
        raise ValueError(f"{name}: operand of shape {tuple(x.shape)} with {len(factors)} factors")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the tensor must be contiguous")
    if batched:
        check_batch(name, x.shape[0])
    for d, f in enumerate(factors):
        if f.device != x.device or f.dtype != x.dtype or not f.is_contiguous():
            raise ValueError(
                f"{name}: factor {d} must be a contiguous {x.dtype} tensor on {x.device}"
            )
        want = (x.shape[1 + lead + d], rank)
        if tuple(f.shape) != want and not (batched and tuple(f.shape) == (x.shape[0], *want)):
            expected = f"{want} or {(x.shape[0], *want)}" if batched else f"{want}"
            raise ValueError(f"{name}: factor {d} has shape {tuple(f.shape)}, "
                             f"expected {expected}")


def check_smem(name: str, plan, smem: int) -> None:
    """Raise if a plan needs more shared memory than one CTA has."""
    if smem > SMEM_PER_CTA_MAX:
        raise ValueError(
            f"{name}: plan {plan} needs {smem} bytes of shared memory; a CTA has at most "
            f"{SMEM_PER_CTA_MAX}"
        )


def copy_width(run_bytes: int, ptrs: Sequence[int], strides: Sequence[int] = ()) -> int:
    """The widest ``cp.async`` (16, 8 or 4 bytes) that every run start can
    take: runs of ``run_bytes`` bytes (X's last axis, a factor's row) from
    pointers ``ptrs`` and, in a batch, from each pointer plus multiples of
    its batch stride (``strides``, bytes: element b of a batch starts b
    strides further on); 0 (element loads) where not even 4 bytes can."""
    for v in (16, 8, 4):
        if run_bytes % v == 0 and all(p % v == 0 for p in (*ptrs, *strides)):
            return v
    return 0


def kernel_plan(name: str, x: torch.Tensor, rank, plan, *,
                choose=choose_mttkrp_kernel_blocks, cls: type = MTTKRPKernelPlan):
    """``plan``, or the kernel's own default ``choose(x.shape, rank,
    itemsize)`` (for a batch, ``x`` is one element: the blocks never depend
    on B); raises ``TypeError`` for a plan of another type than ``cls`` (a
    ``BlockPlan`` or ``MultiTTMPlan`` budgets the reference's tile schedule,
    which these kernels do not run)."""
    if plan is None:
        return choose(tuple(x.shape), rank, x.element_size())
    if not isinstance(plan, cls):
        raise TypeError(f"{name}: on a CUDA tensor the plan is a {cls.__name__}, "
                        f"got {type(plan).__name__}")
    return plan


def check_extents(name: str, shape: Sequence[int]) -> None:
    """Raise unless the ring kernels' 32-bit row and chunk indices hold for
    one problem of ``shape`` (a batch's element; the batch offsets are
    64-bit): ``I`` and ``prod(C)`` below 2^31."""
    if shape[0] >= 2 ** 31 or math.prod(shape[1:]) >= 2 ** 31:
        raise ValueError(f"{name}: I and prod(C) must stay below 2^31, got {tuple(shape)}")


def launch_tile(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    plan: MTTKRPKernelPlan | None,
    *,
    specialized: bool,
    name: str,
) -> torch.Tensor:
    """Launch the MTTKRP kernel on mode-0-canonical CUDA operands and, when
    K is split, the reduction kernel. Returns the fp32 ``(I, R)`` output.
    ``x`` with one axis more than ``len(factors) + 1`` is a batch ``(B, I,
    C_1..C_k)`` of B problems, each factor ``(B, C_d, R)`` or shared
    ``(C_d, R)``: one launch for all of them (the batch is the grid's z
    dimension), at most one reduction, a ``(B, I, R)`` output. Checks
    device, dtype, shape and contiguity first, then the plan's type, blocks
    and shared memory."""
    rank = factors[0].shape[-1] if factors else 0
    batched = x.ndim == len(factors) + 2
    check_operands(name, x, factors, rank, batched=batched)
    shape = tuple(x.shape[1:]) if batched else tuple(x.shape)
    batch = x.shape[0] if batched else 1
    check_extents(name, shape)
    itemsize = x.element_size()
    plan = kernel_plan(name, x[0] if batched else x, rank, plan)
    check_smem(name, plan, mttkrp_kernel_smem_bytes(plan, itemsize, len(shape) - 1))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    _, _, splits = mttkrp_kernel_grid(shape, rank, plan, sms, batch)
    i_sz = shape[0]
    out = torch.empty((batch, i_sz, rank), device=x.device, dtype=torch.float32)
    ws = out if splits == 1 else torch.empty(
        (splits, batch, i_sz, rank), device=x.device, dtype=torch.float32)
    k = len(factors)
    ll = ctypes.c_longlong
    ptrs = [f.data_ptr() for f in factors]
    x_bs = x.stride(0) if batched else 0
    f_bs = [batch_stride(f, 2) for f in factors]
    copy_x = copy_width(shape[-1] * itemsize, [x.data_ptr()], [x_bs * itemsize])
    copy_f = copy_width(rank * itemsize, ptrs, [s * itemsize for s in f_bs])
    lib = launch_library("mttkrp.cu", ws)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_mttkrp_tile(
            int(specialized), 0 if x.dtype == torch.float32 else 1, k, (ll * (k + 1))(*shape),
            plan.block_i, plan.block_k, plan.block_r, plan.stages, rank, splits,
            copy_x, copy_f, batch, x_bs, (ll * k)(*f_bs), x.data_ptr(), (ll * k)(*ptrs),
            ws.data_ptr(), stream,
        )
    check(err, name)
    if collect.SINKS:
        collect.report(name, plan, collect.nbytes(x, *factors), collect.nbytes(ws),
                       collect.dtype_name(ws))
    if splits > 1:
        splitk_reduce(ws, out)
    return out if batched else out[0]


def report_tile_plain(name: str, x: torch.Tensor, factors: Sequence[torch.Tensor],
                      plan) -> None:
    """For a CPU operand, report the launches :func:`launch_tile` would
    make on an H100 (:mod:`repro_torch.observe.collect`): the kernel under
    ``plan`` (the chooser's where ``plan`` is not an ``MTTKRPKernelPlan``,
    since a CPU tensor ignores it) and, where that plan splits, the
    reduction."""
    rank = int(factors[0].shape[-1])
    batched = x.ndim == len(factors) + 2
    shape = tuple(x.shape[1:]) if batched else tuple(x.shape)
    batch = x.shape[0] if batched else 1
    if not isinstance(plan, MTTKRPKernelPlan):
        plan = choose_mttkrp_kernel_blocks(shape, rank, x.element_size())
    splits = mttkrp_kernel_grid(shape, rank, plan, H100_SMS, batch)[2]
    collect.report_split(name, plan, collect.nbytes(x, *factors),
                         batch * shape[0] * rank * 4, splits)
