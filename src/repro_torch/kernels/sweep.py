"""The fused CP-ALS sweep's opening pair on Hopper: the wrapper, its plain
version, and its launch count.

Source: ``csrc/sweep.cu`` (``fused_pair_kernel<T>``). It replaces the TPU
kernel ``repro/kernels/sweep.py:mttkrp_fused_pair_pallas``
(``_fused_pair_kernel``): one pass over a mode-0-canonical
``X (I, C_1..C_{N-1})`` gives both

    B0(i, r)              = sum_c X(i, c..) prod_d A_d(c_d, r)
    P(i, c_1..c_{N-2}, r) = sum_{c_{N-1}} X(i, c..) A_{N-1}(c_{N-1}, r).

What bounds it on an H100: at 1000^3, R=64 (fp32) the 1.28e11 operations on
the CUDA cores (1.91 ms at 67 TFLOP/s); at 180^4, R=32 the 4.95e9 bytes of
X and P (1.48 ms at 3.35 TB/s). The design is a two-level reduction: a CTA
owns an (i, r) tile and a range of c_1 tiles; for each tile of the leading
axes c_1..c_{N-2} it walks c_{N-1} inside the kernel, accumulating the P
tile in fp32 registers from X and the A_{N-1} tile, writes that finished
tile (P's tiles are disjoint between CTAs), and contracts it with the
Khatri-Rao block of A_1..A_{N-2} into B0. B0's per-split slabs are added by
``splitk.splitk_reduce`` in a fixed order. That is 2|X|R operations, not
the 4|X|R of building the full weight and taking both products, and each X
tile is read once per rank tile. Ragged edges are masked; nothing is
padded.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..engine.plan import BlockPlan, Memory, choose_sweep_blocks
from .build import check, library
from .mttkrpn import mttkrpn_plain
from .splitk import c_args, check_operands, check_smem, split_output, splitk_reduce


def fused_pair_plain(
    x: torch.Tensor, factors: Sequence[torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version in float32: ``P = X(-1, C_last) @ A_last`` reshaped,
    and ``B0 = mttkrpn_plain(X, factors)``."""
    rank = factors[-1].shape[1]
    p = x.float().reshape(-1, x.shape[-1]) @ factors[-1].float()
    return mttkrpn_plain(x, factors), p.reshape(tuple(x.shape[:-1]) + (rank,))


def smem_bytes(plan: BlockPlan, dtype: torch.dtype) -> int:
    """Dynamic shared memory the pair kernel takes under ``plan``."""
    nc = len(plan.block_contract)
    bc = (ctypes.c_int * nc)(*plan.block_contract)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return int(library("sweep.cu").repro_fused_pair_smem_bytes(
        itemsize, nc, bc, plan.block_i, plan.block_r))


def fused_pair(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    *,
    plan: BlockPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B0, P)`` from one pass over a mode-0-canonical ``(I, C_1..C_{N-1})``
    tensor, N >= 3, with its N-1 factors in axis order; both float32, P of
    shape ``(I, C_1..C_{N-2}, R)``. A CUDA tensor launches the kernel under
    ``plan`` (default: :func:`choose_sweep_blocks` against
    ``Memory.h100_smem()``); a CPU tensor takes :func:`fused_pair_plain`."""
    if x.ndim < 3 or len(factors) != x.ndim - 1:
        raise ValueError(f"fused_pair: a tensor of 3 or more axes with one factor per "
                         f"contraction axis, got {tuple(x.shape)} and {len(factors)} factors")
    if x.device.type == "cpu":
        return fused_pair_plain(x, factors)
    rank = factors[0].shape[1]
    if plan is None:
        plan = choose_sweep_blocks(x.shape, rank,
                                   memory=Memory.h100_smem(itemsize=x.element_size()))
    check_operands("fused_pair", x, factors, rank, plan)
    lib = library("sweep.cu")
    check_smem("fused_pair", plan, smem_bytes(plan, x.dtype))
    b0, ws, splits = split_output(x, rank, plan)
    p = torch.empty(tuple(x.shape[:-1]) + (rank,), device=x.device, dtype=torch.float32)
    extents, blocks, ptrs, dtype = c_args(x, factors, plan)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_fused_pair(dtype, len(factors), extents, blocks, plan.block_r, rank,
                                   splits, x.data_ptr(), ptrs, ws.data_ptr(), p.data_ptr(),
                                   stream)
    check(err, "fused_pair")
    fused_pair.launches += 1
    if splits > 1:
        splitk_reduce(ws, b0)
    return b0, p


fused_pair.launches = 0  # type: ignore[attr-defined]


def fused_pair_canonical(
    x: torch.Tensor,
    fs: Sequence[torch.Tensor],
    *,
    plan: BlockPlan | None = None,
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
