"""Kernel-backed dimension trees: all-mode MTTKRP and ALS sweeps.
Counterpart of ``repro.engine.tree``.

A binary dimension tree (Phan et al.) shares partial contractions between
the N MTTKRPs of a sweep: split the mode set in half, contract the tensor
once with each half's factors, and recurse. Every tree edge is
MTTKRP-shaped, so each goes through
:func:`repro_torch.engine.execute.contract_partial` under one
:class:`~.context.ExecutionContext`; on ``cuda`` the edges run on the
MTTKRP kernels (the root's edges) and the rank-augmented partial kernel
(every edge below).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..observe import trace as _otrace
from .context import ExecutionContext
from .execute import contract_partial, mttkrp


def _solve_tree(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    leaf_fn: Callable[[int, torch.Tensor], None],
    ctx: ExecutionContext,
) -> None:
    """Walk the binary dimension tree, calling ``leaf_fn(mode, b)`` at each
    leaf with that mode's MTTKRP.

    The order is load-bearing for Gauss-Seidel sweeps: a node's left child
    is contracted (with the right half's factors not yet updated) and fully
    solved before the right child is formed, and ``contract_partial`` reads
    ``factors`` at call time, so if ``leaf_fn`` updates ``factors`` in
    place every leaf sees exactly the factors sequential ALS would use."""

    def solve(node, modes, has_rank):
        if len(modes) == 1:
            leaf_fn(modes[0], node)
            return
        half = max(1, len(modes) // 2)
        left, right = modes[:half], modes[half:]
        for child, drop in ((left, right), (right, left)):
            solve(contract_partial(node, factors, modes, drop, has_rank, ctx=ctx), child, True)

    solve(x, tuple(range(x.ndim)), False)


def all_mode_mttkrp(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    *,
    method: str = "dimtree",
    ctx: ExecutionContext | None = None,
) -> list[torch.Tensor]:
    """MTTKRP in every mode: ``[B^(0), ..., B^(N-1)]``. ``"independent"``
    runs N separate MTTKRPs; ``"dimtree"`` shares the upper tree's partial
    contractions (and records a ``dimtree_sweep`` span under an admitting
    trace, beside each edge's ``contract_partial`` span)."""
    ctx = ctx if ctx is not None else ExecutionContext.default()
    if method == "independent":
        return [mttkrp(x, factors, m, ctx=ctx) for m in range(x.ndim)]
    if method != "dimtree":
        raise ValueError(f"unknown method {method!r}; expected 'dimtree' or 'independent'")
    if _otrace.should_record(ctx.observe, x, *factors):
        _otrace.record_event("dimtree_sweep", shape=list(x.shape),
                             rank=int(factors[0].shape[1]), backend=ctx.backend, n_modes=x.ndim)
    results: dict[int, torch.Tensor] = {}
    _solve_tree(x, factors, results.__setitem__, ctx)
    return [results[m] for m in range(x.ndim)]


def dimtree_als_sweep(
    x: torch.Tensor,
    factors: list[torch.Tensor],
    update_fn: Callable[[int, torch.Tensor], torch.Tensor],
    *,
    ctx: ExecutionContext | None = None,
) -> None:
    """One ALS sweep with dimension-tree reuse, in exactly the Gauss-Seidel
    order of plain ALS. ``update_fn(mode, b)`` returns the new factor and
    may keep its own side state; ``factors`` is updated in place."""
    ctx = ctx if ctx is not None else ExecutionContext.default()

    def leaf(mode: int, b: torch.Tensor) -> None:
        factors[mode] = update_fn(mode, b)

    _solve_tree(x, factors, leaf, ctx)
