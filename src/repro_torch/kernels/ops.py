"""Public wrappers for the MTTKRP kernels: mode canonicalization, the
choice between the 3-way specialized and the N-way generic kernel, and the
rank-augmented partial contraction, and the kept-mode Multi-TTM.
Counterpart of ``repro.kernels.ops`` (``mttkrp_canonical_pallas``,
``mttkrp_pallas``, ``mttkrp_partial_canonical_pallas``,
``multi_ttm_canonical_pallas``).

Unlike the reference, nothing here pads: the kernels take unpadded extents
and mask their ragged edges, and the plain versions need no padding. The
transpose that brings the output mode to axis 0 is a
``permute(...).contiguous()`` copy (none for mode 0) for the MTTKRP kernels;
the partial kernel reads its node in place through its strides.

Every wrapper also takes a batch of problems of one shape (the reference's
``jax.vmap`` over its kernels): a leading batch axis on the tensor, kept
first by every permute, and per-element ``(B, I_k, R)`` or shared
``(I_k, R)`` factors. Each batch is one kernel launch.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..engine.plan import BlockPlan, MTTKRPKernelPlan, MultiTTMKernelPlan, PartialKernelPlan
from .mttkrp3 import mttkrp3
from .mttkrpn import mttkrpn
from .multi_ttm import multi_ttm_keep
from .partial import mttkrp_partial


def mttkrp_canonical(
    xp: torch.Tensor,
    fs: Sequence[torch.Tensor],
    *,
    plan: MTTKRPKernelPlan | None = None,
    out_dtype: torch.dtype | None = None,
    variant: str | None = None,
) -> torch.Tensor:
    """Mode-0-canonical MTTKRP through the blocked kernels.

    ``xp`` has the output mode at axis 0; ``fs`` are the N-1 factors for
    axes 1..N-1 in order, cast to ``xp``'s dtype. An ``xp`` with one axis
    more is a batch (axis 0), each factor ``(B, C_d, R)`` or shared
    ``(C_d, R)``; the result is then ``(B, I, R)``, from one launch.
    ``plan=None`` lets the kernel wrapper plan
    (``choose_mttkrp_kernel_blocks``). ``variant`` pins the
    kernel for 3-way tensors: ``"specialized"`` (the default, ``mttkrp3``)
    or ``"generic"`` (``mttkrpn``); other orders, including a 2-D ``xp``
    with one contraction axis (a dimension-tree edge), take the generic
    kernel.
    The kernels return float32; ``out_dtype`` casts the result.
    """
    if variant not in (None, "specialized", "generic"):
        raise ValueError(f"unknown kernel variant {variant!r}")
    xp = xp.contiguous()
    fs = [f.to(xp.dtype).contiguous() for f in fs]
    if len(fs) == 2 and variant != "generic":  # a 3-way problem
        out = mttkrp3(xp, fs[0], fs[1], plan=plan)
    else:
        out = mttkrpn(xp, fs, plan=plan)
    return out.to(out_dtype) if out_dtype is not None else out


def canonicalize(
    x: torch.Tensor, factors: Sequence[torch.Tensor | None], mode: int,
    batched: bool = False,
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Bring ``mode`` to axis 0 (a contiguous copy unless ``mode == 0``) and
    order the other factors by the remaining axes. ``batched``: axis 0 of
    ``x`` is a batch and stays first (``mode`` counts the element's axes)."""
    lead = int(batched)
    modes = (mode,) + tuple(k for k in range(x.ndim - lead) if k != mode)
    xp = x.permute(tuple(range(lead)) + tuple(lead + k for k in modes)).contiguous()
    return xp, [factors[k] for k in modes[1:]]


def mttkrp(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor | None],
    mode: int,
    *,
    plan: MTTKRPKernelPlan | None = None,
    out_dtype: torch.dtype | None = None,
    variant: str | None = None,
    batched: bool = False,
) -> torch.Tensor:
    """MTTKRP for any mode of an N-way tensor, N >= 2, through the kernels
    (float32 accumulation); the result has ``out_dtype``, by default
    ``x.dtype``. A matrix takes ``mttkrpn`` with one contraction axis (the
    dimension tree's edge path), 3-way tensors ``mttkrp3`` unless
    ``variant="generic"``. ``batched``: axis 0 of ``x`` is a batch of B
    tensors, each factor ``(B, I_k, R)`` or shared ``(I_k, R)``; one launch
    returns ``(B, I_mode, R)``."""
    n = x.ndim - int(batched)
    if n < 2:
        raise ValueError(
            f"the MTTKRP kernels need a tensor of at least 2 modes (one contraction axis "
            f"beside the output mode), got {n}; use backend='einsum'"
        )
    if not 0 <= mode < n:
        raise ValueError(f"mode {mode} out of range for {n}-way tensor")
    xp, fs = canonicalize(x, factors, mode, batched)
    return mttkrp_canonical(
        xp, fs, plan=plan, out_dtype=out_dtype or x.dtype, variant=variant
    )


def mttkrp_partial_canonical(
    node: torch.Tensor,
    fs: Sequence[torch.Tensor],
    *,
    plan: PartialKernelPlan | BlockPlan | None = None,
    out_dtype: torch.dtype | None = None,
    batched: bool = False,
) -> torch.Tensor:
    """Rank-augmented partial contraction (a dimension-tree node): ``node``
    is ``(K_1..K_m, C_1..C_k, R)``, kept modes first, dropped modes next,
    rank last, any view of the node (the kernel reads it in place through
    its strides; nothing is copied or padded); ``fs`` are the k dropped
    factors ``(C_d, R)``, cast to the node's dtype. Returns ``(prod K, R)``:
    float32 from the kernel, cast to ``out_dtype`` when given. ``plan``: a
    ``PartialKernelPlan`` for a CUDA tensor; a CPU tensor ignores it (a
    reference ``BlockPlan`` too). ``batched``: axis 0 is a batch of nodes
    (kept first), each factor ``(B, C_d, R)`` or shared; returns ``(B, prod
    K, R)`` from one launch."""
    fs = [f.to(node.dtype).contiguous() for f in fs]
    out = mttkrp_partial(node, fs, plan=plan, batched=batched)
    return out.to(out_dtype) if out_dtype is not None else out


def multi_ttm_canonical(
    xp: torch.Tensor,
    mats: Sequence[torch.Tensor],
    *,
    plan: MultiTTMKernelPlan | None = None,
    out_dtype: torch.dtype | None = None,
    batched: bool = False,
) -> torch.Tensor:
    """Kept-mode-first Multi-TTM through the kernel: ``xp`` has the kept
    mode at axis 0; ``mats`` are the k contracted-mode matrices ``(C_d,
    R_d)`` for axes 1..k in order, cast to ``xp``'s dtype. Nothing is
    padded (the kernel masks). Returns the flattened ``(I, prod R_d)``
    result, float32 unless ``out_dtype`` casts it. ``batched``: axis 0 of
    ``xp`` is a batch (kept first), each matrix ``(B, C_d, R_d)`` or shared;
    ``(B, I, prod R_d)`` from one launch."""
    xp = xp.contiguous()
    mats = [m.to(xp.dtype).contiguous() for m in mats]
    out = multi_ttm_keep(xp, mats, plan=plan, batched=batched)
    return out.to(out_dtype) if out_dtype is not None else out
