"""The rank-augmented partial contraction on Hopper: the wrapper, its plain
version, and its launch count.

Source: ``csrc/sweep.cu`` (``streaming_partial_kernel<T, V, ROWL, ROWS>``).
It replaces the TPU kernel ``repro/kernels/mttkrpn.py:mttkrp_partial_pallas``
(``_partial_kernel``): a dimension-tree or fused-sweep node that already
carries the rank axis, ``N (K_1..K_m, C_1..C_k, R)``, contracted with the k
dropped factors,

    O(i, r) = sum_{c_1..c_k} N(i, c_1..c_k, r) prod_d A_d(c_d, r),  k >= 1,

i the row-major flat index of the kept axes ``K_1..K_m``.

What bounds it on an H100: with the rank axis on the node there is no
product for the tensor cores; each node element is read once and used once,
so it is bound by the node's bytes (a (1000, 1000, 64) fp32 node is
2.56e8 B, 0.077 ms at 3.35 TB/s). The design is a streaming reduction that
reads the node in place, through its strides (the rank axis at unit
stride), so the engine makes no canonical copy in front: 16-byte read-only
loads along r, several independent loads in flight a thread, weight vectors
formed in registers from the factor rows and reused across a thread's rows,
the warp spanning the axis that lies next to r in memory (the innermost
kept axis, each sum whole in one thread, or the innermost contraction axis,
sums folded across threads in a fixed order). The contraction is split over
CTAs and ``splitk.splitk_reduce`` adds the splits' slabs in a fixed order.
Its plan is :class:`~repro_torch.engine.plan.PartialKernelPlan`, chosen from
the node's shape and strides by
:func:`~repro_torch.engine.plan.choose_partial_kernel_blocks` (cached).
Ragged edges are masked; nothing is padded. A batch of B nodes of one view
(``batched=True``: a leading batch axis) is one launch, the batch the grid's
z dimension; the plan is the element's, its split count chosen for B times
the element's CTAs.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch

from ..core.krp import khatri_rao
from ..engine.plan import (
    H100_SMS,
    PARTIAL_LAYOUTS,
    PARTIAL_VEC_BYTES,
    PartialKernelPlan,
    choose_partial_kernel_blocks,
    partial_kernel_smem_bytes,
)
from ..observe import collect
from .build import check, count_launch, launch_library, library
from .splitk import batch_stride, check_batch, check_smem, splitk_reduce


def mttkrp_partial_plain(node: torch.Tensor, factors: Sequence[torch.Tensor],
                         batched: bool = False) -> torch.Tensor:
    """Plain version: ``(N * W).sum`` over the flattened contraction axes in
    float32, with W the Khatri-Rao product of the factors, the last factor's
    index fastest (C-order over the node's contraction axes). The leading
    ``node.ndim - 1 - len(factors)`` axes are kept and flattened into the
    output's rows. ``batched``: axis 0 is a batch, each factor ``(B, C_d,
    R)`` or shared ``(C_d, R)``; returns ``(B, rows, R)``."""
    w = khatri_rao([f.float() for f in reversed(factors)])
    lead = int(batched)
    rows = math.prod(node.shape[lead:node.ndim - 1 - len(factors)])
    n = node.float().reshape(*node.shape[:lead], rows, -1, node.shape[-1])
    return (n * (w[:, None] if w.ndim == 3 else w)).sum(-2)


def smem_bytes(plan: PartialKernelPlan, dtype: torch.dtype, rank: int) -> int:
    """The library's own count of the partial kernel's dynamic shared memory
    under ``plan`` for rank ``rank`` (-1 for a plan it does not take);
    :func:`~repro_torch.engine.plan.partial_kernel_smem_bytes` mirrors it."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return int(library("sweep.cu").repro_partial_smem_bytes(
        itemsize, PARTIAL_LAYOUTS.index(plan.layout), plan.block_rows, plan.vec, plan.loads,
        rank))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def node_view(node: torch.Tensor, nkeep: int
              ) -> tuple[list[int], list[int], list[int], list[int], list[int]]:
    """The kernel's view of ``node``: kept sizes and strides with the kept
    axes merged where their strides allow it (size-1 axes dropped; one axis
    of size 1 if none is left), and the contraction axes reordered by
    decreasing stride (the innermost last), with that order (``order[d]``:
    the contraction axis at position d). Strides in elements."""
    keep: list[list[int]] = []
    for size, stride in zip(node.shape[:nkeep], node.stride()[:nkeep]):
        if size == 1:
            continue
        if keep and keep[-1][1] == size * stride:
            keep[-1] = [keep[-1][0] * size, stride]
        else:
            keep.append([size, stride])
    keep = keep or [[1, 0]]
    csizes, cstrides = node.shape[nkeep:-1], node.stride()[nkeep:-1]
    order = sorted(range(len(csizes)), key=lambda d: -cstrides[d])
    return ([s for s, _ in keep], [t for _, t in keep], [csizes[d] for d in order],
            [cstrides[d] for d in order], order)


def _kernel_view(node: torch.Tensor, factors: Sequence[torch.Tensor], batched: bool = False):
    """:func:`node_view` of a node (of one element of a batch) with
    ``len(factors)`` contraction axes, the factors in the view's contraction
    order, the batch strides of the node and of those factors (0 unbatched,
    and for a factor the batch shares), and whether every element's
    pointers take 16-byte loads (each pointer and, in a batch, each batch
    stride a multiple of 16 bytes)."""
    elem = node[0] if batched else node
    ksizes, kstrides, csizes, cstrides, order = node_view(elem, elem.ndim - 1 - len(factors))
    fs = [factors[d] for d in order]
    node_bs = node.stride(0) if batched else 0
    f_bs = [batch_stride(f, 2) for f in fs]
    aligned = (all(t.data_ptr() % PARTIAL_VEC_BYTES == 0 for t in [node, *fs])
               and all(b * node.element_size() % PARTIAL_VEC_BYTES == 0
                       for b in (node_bs, *f_bs)))
    return ksizes, kstrides, csizes, cstrides, fs, node_bs, f_bs, aligned


def default_plan(node: torch.Tensor, factors: Sequence[torch.Tensor],
                 batched: bool = False) -> PartialKernelPlan:
    """The plan :func:`mttkrp_partial` chooses for a CUDA ``node`` (rank axis
    at unit stride; ``batched``: a batch of nodes along axis 0) and its
    factors; for a CPU ``node``, the plan it would get on an H100."""
    ksizes, kstrides, csizes, cstrides, _, _, _, aligned = _kernel_view(node, factors, batched)
    sms = _sms(node.device.index or 0) if node.is_cuda else H100_SMS
    return choose_partial_kernel_blocks(
        (*ksizes, *csizes), (*kstrides, *cstrides), node.shape[-1], node.element_size(),
        sms, nkeep=len(ksizes), aligned=aligned,
        batch=node.shape[0] if batched else 1)


def mttkrp_partial(
    node: torch.Tensor,
    factors: Sequence[torch.Tensor],
    *,
    plan: PartialKernelPlan | None = None,
    batched: bool = False,
) -> torch.Tensor:
    """Rank-augmented partial contraction of a ``(K_1..K_m, C_1..C_k, R)``
    node, m >= 0 kept axes first, with its k ``(C_d, R)`` factors; returns
    float32 ``(prod K, R)``. ``batched``: axis 0 of the node is a batch of B
    nodes, each factor ``(B, C_d, R)`` or shared ``(C_d, R)``; one launch
    returns ``(B, prod K, R)``. A CUDA tensor is read in place through its
    strides (a node whose rank axis is not at unit stride gets one
    ``.contiguous()``) and launches the kernel under ``plan`` (default:
    :func:`choose_partial_kernel_blocks` for its view; any other plan type
    raises ``TypeError``); a CPU tensor ignores ``plan`` and takes
    :func:`mttkrp_partial_plain`."""
    k = len(factors)
    lead = int(batched)
    if not factors or node.ndim < k + 1 + lead:
        raise ValueError(f"mttkrp_partial: node of shape {tuple(node.shape)} with "
                         f"{k} factors (batched={batched})")
    if node.device.type == "cpu":
        return collect.stand_in(lambda: mttkrp_partial_plain(node, factors, batched),
                                lambda: _report_plain(node, factors, plan, batched))
    name = "mttkrp_partial"
    if node.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs a CUDA tensor, got {node.device}")
    if node.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: float32 or bfloat16 input, got {node.dtype}")
    rank, nkeep = node.shape[-1], node.ndim - 1 - k - lead
    if not 1 <= k <= 7 or nkeep > 7:
        raise ValueError(f"{name}: {k} contraction and {nkeep} kept axes; the kernel takes "
                         f"1 to 7 of each")
    batch = node.shape[0] if batched else 1
    if batched:
        check_batch(name, batch)
    for d, f in enumerate(factors):
        if f.device != node.device or f.dtype != node.dtype or not f.is_contiguous():
            raise ValueError(
                f"{name}: factor {d} must be a contiguous {node.dtype} tensor on {node.device}")
        want = (node.shape[lead + nkeep + d], rank)
        if tuple(f.shape) != want and not (batched and tuple(f.shape) == (batch, *want)):
            raise ValueError(f"{name}: factor {d} has shape {tuple(f.shape)}, expected "
                             f"{want}" + (f" or {(batch, *want)}" if batched else ""))
    if node.stride(-1) != 1 and rank > 1:
        node = node.contiguous()
    ksizes, kstrides, csizes, cstrides, fs, node_bs, f_bs, aligned = _kernel_view(
        node, factors, batched)
    rows = math.prod(ksizes)
    out_shape = (batch, rows, rank) if batched else (rows, rank)
    if node.numel() == 0:
        return torch.zeros(out_shape, device=node.device, dtype=torch.float32)
    itemsize = node.element_size()
    wide = PARTIAL_VEC_BYTES // itemsize
    if plan is None:
        plan = choose_partial_kernel_blocks(
            (*ksizes, *csizes), (*kstrides, *cstrides), rank, itemsize,
            _sms(node.device.index or 0), nkeep=len(ksizes), aligned=aligned, batch=batch)
    elif not isinstance(plan, PartialKernelPlan):
        raise TypeError(f"{name}: on a CUDA tensor the plan is a PartialKernelPlan, "
                        f"got {type(plan).__name__}")
    plan.check(rank, itemsize)
    if plan.vec > 1 and not (aligned and all(s % wide == 0 for s in kstrides + cstrides)):
        raise ValueError(f"{name}: plan {plan} loads {PARTIAL_VEC_BYTES} bytes, but the node's "
                         f"strides, batch strides or a pointer are not multiples of them")
    check_smem(name, plan, partial_kernel_smem_bytes(plan, rank))
    out = torch.empty(out_shape, device=node.device, dtype=torch.float32)
    ws = out if plan.splits == 1 else torch.empty(
        (plan.splits, *out_shape), device=node.device, dtype=torch.float32)
    lib = launch_library("sweep.cu", ws)
    ll = ctypes.c_longlong
    nk, nc = len(ksizes), len(csizes)
    with torch.cuda.device(node.device):
        stream = torch.cuda.current_stream(node.device).cuda_stream
        err = lib.repro_partial(
            0 if node.dtype == torch.float32 else 1, PARTIAL_LAYOUTS.index(plan.layout),
            plan.block_rows, plan.vec, plan.loads, plan.splits, nk, (ll * nk)(*ksizes),
            (ll * nk)(*kstrides), nc, (ll * nc)(*csizes), (ll * nc)(*cstrides), rank,
            batch, node_bs, (ll * nc)(*f_bs), node.data_ptr(),
            (ll * nc)(*(f.data_ptr() for f in fs)), ws.data_ptr(), stream)
    check(err, name)
    count_launch(mttkrp_partial)
    if collect.SINKS:
        collect.report(name, plan, collect.nbytes(node, *factors), collect.nbytes(ws),
                       collect.dtype_name(ws))
    if plan.splits > 1:
        splitk_reduce(ws, out)
    return out


mttkrp_partial.launches = 0  # type: ignore[attr-defined]


def _report_plain(node: torch.Tensor, factors, plan, batched: bool) -> None:
    """The launches :func:`mttkrp_partial` would make on an H100 for a CPU
    ``node`` (:mod:`repro_torch.observe.collect`): the node is read in
    place, so its elements count once."""
    if not isinstance(plan, PartialKernelPlan):
        plan = default_plan(node, factors, batched)
    rows = math.prod(node.shape[int(batched):node.ndim - 1 - len(factors)])
    batch = node.shape[0] if batched else 1
    collect.report_split("mttkrp_partial", plan, collect.nbytes(node, *factors),
                         batch * rows * node.shape[-1] * 4, plan.splits)
