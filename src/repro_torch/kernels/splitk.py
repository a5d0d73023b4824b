"""The split-contraction launch shared by the two MTTKRP kernels, and the
deterministic reduction kernel that adds the splits.

Source: ``csrc/mttkrp.cu`` (``splitk_reduce_kernel``). It replaces what the
TPU kernels get from their sequential grid: the output tile stays resident
across the contraction steps (``repro/kernels/mttkrp3.py:67-69``). On
Hopper the CTAs run in parallel and in no order, so the outermost
contraction axis is split over ``S`` CTAs, each writing an fp32 slab of an
``(S, I, R)`` workspace, and this kernel sums the slabs in slab order: no
atomics, the same bits on every run. It moves ``(S + 1) * I * R * 4``
bytes and is bound by memory bandwidth.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from ..engine.plan import SMEM_PER_CTA_MAX, BlockPlan
from .build import check, library

#: CTAs wanted in flight: two per SM (the planner's budget lets two share one).
CTAS_PER_SM = 2


def splitk_reduce_plain(ws: torch.Tensor) -> torch.Tensor:
    """Plain version: the sum over the leading (split) axis."""
    return ws.sum(dim=0)


def splitk_reduce(ws: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out = ws.sum(0)`` for an fp32 ``(S, I, R)`` workspace, in slab order.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel."""
    if ws.device.type == "cpu":
        out.copy_(splitk_reduce_plain(ws))
        return out
    if ws.device.type != "cuda" or out.device != ws.device:
        raise ValueError(f"splitk_reduce: needs CUDA tensors, got {ws.device}, {out.device}")
    if ws.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError("splitk_reduce: workspace and output must be float32")
    if ws.ndim != 3 or tuple(out.shape) != tuple(ws.shape[1:]):
        raise ValueError(f"splitk_reduce: shapes {tuple(ws.shape)} -> {tuple(out.shape)}")
    if not (ws.is_contiguous() and out.is_contiguous()):
        raise ValueError("splitk_reduce: tensors must be contiguous")
    lib = library()
    with torch.cuda.device(ws.device):
        stream = torch.cuda.current_stream(ws.device).cuda_stream
        err = lib.repro_splitk_reduce(
            ws.data_ptr(), out.data_ptr(), out.numel(), ws.shape[0], stream
        )
    check(err, "splitk_reduce")
    splitk_reduce.launches += 1
    return out


splitk_reduce.launches = 0  # type: ignore[attr-defined]


def n_splits(ctas: int, outer_tiles: int, sms: int) -> int:
    """Splits of the outermost contraction axis: enough that
    ``ctas * S >= CTAS_PER_SM * sms``, never more than its tiles."""
    return max(1, min(outer_tiles, math.ceil(CTAS_PER_SM * sms / max(ctas, 1))))


def smem_bytes(plan: BlockPlan, dtype: torch.dtype) -> int:
    """Dynamic shared memory the tile kernel takes under ``plan``."""
    nc = len(plan.block_contract)
    bc = (ctypes.c_int * nc)(*plan.block_contract)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return int(library().repro_mttkrp_smem_bytes(itemsize, nc, bc, plan.block_i, plan.block_r))


def launch_tile(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    plan: BlockPlan,
    *,
    specialized: bool,
    name: str,
) -> torch.Tensor:
    """Launch the blocked tile kernel on mode-0-canonical CUDA operands and,
    when the contraction is split, the reduction kernel. Returns the fp32
    ``(I, R)`` output. Checks device, dtype, shape and contiguity first."""
    n = x.ndim
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: float32 or bfloat16 input, got {x.dtype}")
    if len(factors) != n - 1 or n < 2 or n - 1 > 7:
        raise ValueError(f"{name}: {n}-way tensor with {len(factors)} factors")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the tensor must be contiguous")
    rank = factors[0].shape[1]
    for d, f in enumerate(factors):
        if f.device != x.device or f.dtype != x.dtype or not f.is_contiguous():
            raise ValueError(
                f"{name}: factor {d} must be a contiguous {x.dtype} tensor on {x.device}"
            )
        if tuple(f.shape) != (x.shape[1 + d], rank):
            raise ValueError(f"{name}: factor {d} has shape {tuple(f.shape)}, "
                             f"expected {(x.shape[1 + d], rank)}")
    if len(plan.block_contract) != n - 1 or plan.x_has_rank:
        raise ValueError(f"{name}: plan {plan} does not fit a {n}-way MTTKRP")
    lib = library()
    smem = smem_bytes(plan, x.dtype)
    if smem > SMEM_PER_CTA_MAX:
        raise ValueError(
            f"{name}: plan {plan} needs {smem} bytes of shared memory; a CTA has at most "
            f"{SMEM_PER_CTA_MAX} (plan against Memory.h100_smem())"
        )
    i_sz = x.shape[0]
    gi = math.ceil(i_sz / plan.block_i)
    gr = math.ceil(rank / plan.block_r)
    outer = math.ceil(x.shape[1] / plan.block_contract[0])
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = n_splits(gi * gr, outer, sms)
    out = torch.empty((i_sz, rank), device=x.device, dtype=torch.float32)
    ws = out if splits == 1 else torch.empty(
        (splits, i_sz, rank), device=x.device, dtype=torch.float32
    )
    extents = (ctypes.c_longlong * n)(*x.shape)
    blocks = (ctypes.c_int * n)(plan.block_i, *plan.block_contract)
    ptrs = (ctypes.c_longlong * (n - 1))(*(f.data_ptr() for f in factors))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_mttkrp_tile(
            int(specialized), 0 if x.dtype == torch.float32 else 1, n - 1, extents, blocks,
            plan.block_r, rank, splits, x.data_ptr(), ptrs, ws.data_ptr(), stream,
        )
    check(err, name)
    if splits > 1:
        splitk_reduce(ws, out)
    return out
