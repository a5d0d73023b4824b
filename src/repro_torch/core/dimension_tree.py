"""Dimension-tree multi-mode MTTKRP (paper §VII outlook; Phan et al.):
the entry points and the analytic flop models. Counterpart of
``repro.core.dimension_tree``; the tree itself runs in
:mod:`repro_torch.engine.tree`.

A dimension tree shares partial contractions between the N MTTKRPs of a
sweep: about two tensor-sized contractions a sweep instead of N, each
partial contraction MTTKRP-shaped and blocked by the same machinery.
"""

from __future__ import annotations

from typing import Sequence

# The reference's entry points, re-exported from the engine, which runs the
# tree (``all_mode_mttkrp``'s default method is the dimension tree).
from ..engine.tree import all_mode_mttkrp as all_mode_mttkrp_dimtree
from ..engine.tree import dimtree_als_sweep

__all__ = ["all_mode_mttkrp_dimtree", "dimtree_als_sweep", "dimtree_flops",
           "dimtree_intermediate_words", "naive_all_mode_flops"]


def dimtree_flops(dims: Sequence[int], rank: int) -> int:
    """Exact multiply-add count of one dimension-tree sweep.

    Each einsum contraction pairs the dropped factors one at a time; a
    pairing that drops mode ``m`` from a node with remaining mode sizes
    ``cur`` costs ``prod(cur) * R`` multiply-adds, whether the rank axis is
    already on the node or appears with this first pairing. The drop order
    matters: einsum's optimal path drops the largest mode first. Compare
    naive all-mode MTTKRP: ``N * (N-1) * I * R``.
    """
    total = 0

    def contract_cost(sizes: tuple[int, ...], drop: tuple[int, ...]) -> int:
        cost = 0
        cur = list(sizes)
        for s in sorted((sizes[m] for m in drop), reverse=True):
            vol = 1
            for c in cur:
                vol *= c
            cost += vol * rank
            cur.remove(s)
        return cost

    def rec(sizes: tuple[int, ...]):
        nonlocal total
        if len(sizes) == 1:
            return
        half = max(1, len(sizes) // 2)
        total += contract_cost(sizes, tuple(range(half, len(sizes))))
        total += contract_cost(sizes, tuple(range(half)))
        rec(sizes[:half])
        rec(sizes[half:])

    rec(tuple(dims))
    return total


def dimtree_intermediate_words(dims: Sequence[int], rank: int) -> int:
    """Total words of every tree node (the reuse working set): a
    rank-augmented node holds ``prod(dims) * R`` words, the root
    ``prod(dims)``."""
    total = 0

    def rec(sizes: tuple[int, ...], has_rank: bool):
        nonlocal total
        vol = 1
        for s in sizes:
            vol *= s
        total += vol * (rank if has_rank else 1)
        if len(sizes) == 1:
            return
        half = max(1, len(sizes) // 2)
        rec(sizes[:half], True)
        rec(sizes[half:], True)

    rec(tuple(dims), False)
    return total


def naive_all_mode_flops(dims: Sequence[int], rank: int) -> int:
    """N independent MTTKRPs, each N-1 pairwise contractions of I*R."""
    n = len(dims)
    vol = 1
    for d in dims:
        vol *= d
    return n * (n - 1) * vol * rank
