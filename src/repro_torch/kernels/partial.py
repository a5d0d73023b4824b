"""The rank-augmented partial contraction on Hopper: the wrapper, its plain
version, and its launch count.

Source: ``csrc/sweep.cu`` (``partial_kernel<T>``). It replaces the TPU
kernel ``repro/kernels/mttkrpn.py:mttkrp_partial_pallas``
(``_partial_kernel``): a dimension-tree node that already carries the rank
axis, ``N (I, C_1..C_k, R)``, contracted with the k dropped factors,

    O(i, r) = sum_{c_1..c_k} N(i, c_1..c_k, r) prod_d A_d(c_d, r),  k >= 1.

What bounds it on an H100: with the rank axis on the node there is no
product for the tensor cores; each node element is read once and used once,
so it is bound by memory bandwidth (a (1000, 1000, 64) fp32 node is
2.56e8 B, 0.076 ms at 3.35 TB/s). The design: threads run along r, the
node's contiguous last axis, so the loads coalesce; the contraction is a
loop inside the CTA with the weight block built per step in shared memory
(k = 1 is the same loop with a one-factor weight); the outermost contraction
axis is split over CTAs and ``splitk.splitk_reduce`` adds the splits in a
fixed order. Ragged edges are masked; nothing is padded.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..core.krp import khatri_rao
from ..engine.plan import BlockPlan, Memory, choose_blocks
from .build import check, library
from .splitk import c_args, check_operands, check_smem, split_output, splitk_reduce


def mttkrp_partial_plain(node: torch.Tensor, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version: ``(N * W).sum`` over the flattened contraction axes in
    float32, with W the Khatri-Rao product of the factors, the last factor's
    index fastest (C-order over the node's contraction axes)."""
    w = khatri_rao([f.float() for f in reversed(factors)])
    n = node.float().reshape(node.shape[0], -1, node.shape[-1])
    return (n * w[None]).sum(1)


def smem_bytes(plan: BlockPlan) -> int:
    """Dynamic shared memory the partial kernel takes under ``plan``."""
    k = len(plan.block_contract)
    bc = (ctypes.c_int * k)(*plan.block_contract)
    return int(library("sweep.cu").repro_partial_smem_bytes(k, bc, plan.block_i, plan.block_r))


def mttkrp_partial(
    node: torch.Tensor,
    factors: Sequence[torch.Tensor],
    *,
    plan: BlockPlan | None = None,
) -> torch.Tensor:
    """Canonical rank-augmented partial contraction of an ``(I, C_1..C_k,
    R)`` node with its k ``(C_d, R)`` factors; returns float32 ``(I, R)``.
    A CUDA tensor launches the kernel under ``plan`` (default: planned
    against ``Memory.h100_smem()`` with ``x_has_rank=True``); a CPU tensor
    takes :func:`mttkrp_partial_plain`."""
    if node.ndim != len(factors) + 2 or not factors:
        raise ValueError(f"mttkrp_partial: node of shape {tuple(node.shape)} with "
                         f"{len(factors)} factors")
    if node.device.type == "cpu":
        return mttkrp_partial_plain(node, factors)
    rank = node.shape[-1]
    if plan is None:
        plan = choose_blocks(node.shape[:-1], rank, x_has_rank=True,
                             memory=Memory.h100_smem(itemsize=node.element_size()))
    check_operands("mttkrp_partial", node, factors, rank, plan, x_has_rank=True)
    lib = library("sweep.cu")
    check_smem("mttkrp_partial", plan, smem_bytes(plan))
    out, ws, splits = split_output(node, rank, plan)
    extents, blocks, ptrs, dtype = c_args(node, factors, plan)
    with torch.cuda.device(node.device):
        stream = torch.cuda.current_stream(node.device).cuda_stream
        err = lib.repro_partial(dtype, len(factors), extents, blocks, plan.block_r, rank,
                                splits, node.data_ptr(), ptrs, ws.data_ptr(), stream)
    check(err, "mttkrp_partial")
    mttkrp_partial.launches += 1
    if splits > 1:
        splitk_reduce(ws, out)
    return out


mttkrp_partial.launches = 0  # type: ignore[attr-defined]
