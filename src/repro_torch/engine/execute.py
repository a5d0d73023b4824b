"""The dispatch layer: one ``mttkrp`` entry point over three backends.
Counterpart of ``repro.engine.execute.mttkrp`` / ``_mttkrp_impl``.

``einsum``        — ``torch.einsum``.
``blocked_host``  — Algorithm 2's blocked schedule as a host-level einsum
                    (:mod:`repro_torch.core.blocked`), the kernels' oracle.
``cuda``          — the hand-written Hopper kernels
                    (:mod:`repro_torch.kernels.ops`), planned by
                    :mod:`repro_torch.engine.plan`.

Configuration comes in as one :class:`~.context.ExecutionContext`;
``plan``, ``block``, ``kernel_variant`` and ``out_dtype`` pin one
contraction's details. Each kernel wrapper counts its own launches
(``mttkrp3.launches``, ``mttkrpn.launches``, ``splitk_reduce.launches``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.blocked import mttkrp_blocked
from ..core.mttkrp import mttkrp as _einsum_mttkrp
from ..kernels import ops as kernel_ops
from ..kernels.ref import mttkrp_ref
from .context import ExecutionContext, torch_dtype
from .plan import BlockPlan, Memory, best_uniform_block, choose_blocks


def _cast_compute(ctx: ExecutionContext, x, arrays, out_dtype):
    """The context's mixed-precision policy: cast the tensor and the factors
    to ``ctx.compute_dtype`` and default the output dtype to the ORIGINAL
    input dtype (bf16 streams, fp32 results). Accumulation stays fp32 on
    every backend. Returns ``(x, arrays, out_dtype, active)``."""
    if ctx.compute_dtype is None:
        return x, arrays, out_dtype, False
    cd = torch_dtype(ctx.compute_dtype)
    if out_dtype is None:
        out_dtype = x.dtype
    x = x.to(cd)
    arrays = [a.to(cd) if a is not None else None for a in arrays]
    return x, arrays, out_dtype, True


def _mode_first(shape: Sequence[int], mode: int) -> tuple[int, ...]:
    return (shape[mode],) + tuple(s for k, s in enumerate(shape) if k != mode)


def mttkrp(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor | None],
    mode: int,
    *,
    ctx: ExecutionContext | None = None,
    plan: BlockPlan | None = None,
    block: int | None = None,
    out_dtype: torch.dtype | None = None,
    kernel_variant: str | None = None,
) -> torch.Tensor:
    """MTTKRP through the engine: ``B^(mode)(i, r)``.

    ``ctx`` defaults to ``ExecutionContext()`` (the ``cuda`` backend on the
    card). ``plan`` pins block sizes for ``cuda``; ``block`` the uniform
    host-blocking size of ``blocked_host``; ``kernel_variant`` the 3-way
    specialized or N-way generic kernel."""
    ctx = ctx if ctx is not None else ExecutionContext()
    ctx.check_tensor("repro_torch.mttkrp", x, *factors)
    if x.ndim != len(factors):
        raise ValueError(
            f"{x.ndim}-way tensor with {len(factors)} factors (a leading batch axis "
            f"comes with the batched-engine slice, ROADMAP Queue 1 item 8)"
        )
    return _mttkrp_impl(x, factors, mode, ctx, plan, block, out_dtype, kernel_variant)


def _mttkrp_impl(x, factors, mode, ctx, plan, block, out_dtype, kernel_variant):
    memory = ctx.memory
    if out_dtype is None and ctx.out_dtype is not None:
        out_dtype = torch_dtype(ctx.out_dtype)
    x, factors, out_dtype, mixed = _cast_compute(ctx, x, factors, out_dtype)
    if ctx.backend == "einsum" or (ctx.backend == "cuda" and x.ndim < 3):
        # (the kernels need >= 2 contraction dims: a shape rule, not a fallback);
        # under a compute-dtype policy the float32 oracle accumulates in fp32
        out = mttkrp_ref(x, factors, mode) if mixed else _einsum_mttkrp(x, factors, mode)
        return out.to(out_dtype) if out_dtype is not None else out
    if ctx.backend == "blocked_host":
        if block is None:
            block = best_uniform_block(x.shape, memory or Memory.abstract(2 ** 20))
        out = mttkrp_blocked(x, factors, mode, block, f32_acc=mixed)
        return out.to(out_dtype) if out_dtype is not None else out
    # cuda
    if plan is None and memory is not None:
        rank = next(f.shape[1] for k, f in enumerate(factors) if k != mode)
        if mixed:
            # dtype-aware planning: same physical budget, narrower items
            memory = memory.with_itemsize(x.element_size())
        plan = choose_blocks(
            _mode_first(x.shape, mode), rank, x.element_size(), memory=memory
        )
    return kernel_ops.mttkrp(
        x, factors, mode, plan=plan, out_dtype=out_dtype, variant=kernel_variant
    )
