"""Fused ALS sweeps: the arXiv:1708.08976 mode-reuse schedule on the
engine's dispatch layer. Counterpart of ``repro.engine.sweep``.

Plain Gauss-Seidel ALS reads the tensor once per mode (N passes a sweep).
The fused schedule reuses ``P = X x_{N-1} A_{N-1}``, computed with the
pre-sweep factors, for every mode but the last:

    P   = X x_{N-1} A_{N-1}        pre-sweep factors (1st tensor pass)
    B0  = P x_{1..N-2} A_d         every dropped factor pre-sweep
    ... solve mode 0 ...; then for m = 1 .. N-2:
    B_m = P x_{d != m} A_d         A_0..A_{m-1} updated, the rest pre-sweep
    ... solve mode m ...; finally
    B_{N-1} = full MTTKRP          all factors updated (2nd tensor pass)

Two tensor passes a sweep instead of N, and every update sees exactly the
factors sequential ALS would: the schedule is Gauss-Seidel exact (results
differ only in summation order).

On the ``cuda`` backend the opening ``(B0, P)`` pair is one launch of the
fused pair kernel (:mod:`repro_torch.kernels.sweep`); the other backends
compute the same two nodes as two ``contract_partial`` calls. On ``auto``
the pair resolves through the tune cache (``kind="pair"``, filled by
``tune_sweep``): ``cuda`` (a miss on a CUDA tensor) launches the kernel with
the resolved plan, anything else takes the two ``contract_partial`` calls,
each resolving its own edge.
"""

from __future__ import annotations

from typing import Callable

import torch

from .context import ExecutionContext, torch_dtype
from .execute import contract_partial, fused_pair, mttkrp
from .plan import MTTKRPKernelPlan


def _fused_pair(x: torch.Tensor, factors, ctx: ExecutionContext, plan=None):
    """The sweep's opening ``(B0, P)`` pair: one fused launch on ``cuda``
    (:func:`~.execute.fused_pair`, under ``plan`` when given), two
    ``contract_partial`` calls elsewhere."""
    n = x.ndim
    if ctx.backend == "auto":
        from ..tune.search import resolve  # call-time: tune imports the engine

        dtype = torch_dtype(ctx.compute_dtype) if ctx.compute_dtype is not None else x.dtype
        r = resolve(x.shape, int(factors[-1].shape[-1]), -1, dtype, ctx.memory, kind="pair",
                    cache=ctx.plan_cache(), device=ctx.device)
        if r.backend == "cuda":
            return fused_pair(x, factors, ctx.concrete("cuda"),
                              plan if plan is not None else r.plan)
    elif ctx.backend == "cuda":
        return fused_pair(x, factors, ctx, plan)
    p = contract_partial(x, factors, tuple(range(n)), (n - 1,), False, ctx=ctx)
    b0 = contract_partial(p, factors, tuple(range(n - 1)), tuple(range(1, n - 1)), True,
                          ctx=ctx)
    return b0, p


def fused_als_sweep(
    x: torch.Tensor,
    factors: list[torch.Tensor],
    update_fn: Callable[[int, torch.Tensor], torch.Tensor],
    *,
    ctx: ExecutionContext | None = None,
    pair_plan: MTTKRPKernelPlan | None = None,
) -> None:
    """One Gauss-Seidel ALS sweep under the mode-reuse schedule.

    ``update_fn(mode, b)`` receives mode ``mode``'s MTTKRP computed with all
    modes < mode already updated, returns the new factor, and may keep its
    own side state; ``factors`` is updated in place. Tensors with fewer than
    3 modes take the per-mode chain (nothing to reuse). ``pair_plan`` pins
    the fused pair kernel's blocks where the pair runs on it."""
    ctx = ctx if ctx is not None else ExecutionContext.default()
    n = x.ndim
    if n < 3:
        for mode in range(n):
            factors[mode] = update_fn(mode, mttkrp(x, factors, mode, ctx=ctx))
        return
    inner = tuple(range(n - 1))
    b0, p = _fused_pair(x, factors, ctx, pair_plan)
    factors[0] = update_fn(0, b0)
    for m in range(1, n - 1):
        drop = tuple(d for d in inner if d != m)
        factors[m] = update_fn(m, contract_partial(p, factors, inner, drop, True, ctx=ctx))
    factors[n - 1] = update_fn(n - 1, mttkrp(x, factors, n - 1, ctx=ctx))
