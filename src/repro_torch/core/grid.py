"""Processor-grid choosers for Algorithms 3 and 4 (pure Python).
Counterpart of ``repro.core.grid``, copied: the results must equal the
reference's exactly.

The paper prescribes (§V-C3, §V-D3, Thm 6.2):

  * Alg 3:  P_k ≈ I_k / (I/P)^{1/N}            (no rank axis, P_0 = 1)
  * Alg 4:  P_0 ≈ (NR)^{N/(2N-1)} / (I/P)^{(N-1)/(2N-1)},
            P_k ≈ I_k / (I·P_0/P)^{1/N}

subject to integrality and ``P_0 · Π P_k = P``. We provide:

  * ``paper_grid``      — the paper's prescription, rounded to a feasible
                          integer factorization (nearest divisors).
  * ``optimal_grid``    — exact minimizer of the Eq (16) cost over all
                          divisor tuples of P (beyond-paper: an exhaustive
                          integer search instead of the asymptotic rule; it
                          can only be <= the paper grid's cost).
  * ``stationary_grid`` — Alg 3's grid (P_0 = 1), rounded feasibly.

The first two return ``(p0, (p1, ..., pN))``, the third ``(p1, ..., pN)``.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Sequence

from .bounds import par_general_cost
from .tensor import total_size


@lru_cache(maxsize=None)
def _divisors(p: int) -> tuple[int, ...]:
    out = [d for d in range(1, p + 1) if p % d == 0]
    return tuple(out)


def _factorization_tuples(p: int, n: int) -> list[tuple[int, ...]]:
    """All ordered tuples (f_1..f_n) of positive ints with prod = p."""
    if n == 1:
        return [(p,)]
    out = []
    for d in _divisors(p):
        for rest in _factorization_tuples(p // d, n - 1):
            out.append((d,) + rest)
    return out


def _nearest_grid(dims: Sequence[int], target: Sequence[float], p: int) -> tuple[int, ...]:
    """Feasible integer grid with prod = p closest (log-distance) to target."""
    n = len(dims)
    best, best_err = None, float("inf")
    for cand in _factorization_tuples(p, n):
        if any(c > d for c, d in zip(cand, dims)):
            continue
        err = sum(
            (math.log(c) - math.log(max(t, 1e-9))) ** 2
            for c, t in zip(cand, target)
        )
        if err < best_err:
            best, best_err = cand, err
    if best is None:  # fall back: allow P_k > I_k (degenerate but valid)
        for cand in _factorization_tuples(p, n):
            err = sum(
                (math.log(c) - math.log(max(t, 1e-9))) ** 2
                for c, t in zip(cand, target)
            )
            if err < best_err:
                best, best_err = cand, err
    return best


def paper_grid(
    dims: Sequence[int], rank: int, procs: int, allow_rank_axis: bool = True
) -> tuple[int, tuple[int, ...]]:
    """The paper's asymptotic prescription, rounded to integer divisors."""
    n = len(dims)
    i = total_size(dims)
    if allow_rank_axis:
        p0_target = (n * rank) ** (n / (2 * n - 1)) / (
            (i / procs) ** ((n - 1) / (2 * n - 1))
        )
    else:
        p0_target = 1.0
    # round P0 to the nearest divisor of P, clamped to [1, min(P, R)]
    p0 = min(
        _divisors(procs), key=lambda d: abs(math.log(d) - math.log(max(p0_target, 1.0)))
    )
    p0 = max(1, min(p0, rank, procs))
    while procs % p0 != 0:
        p0 -= 1
    rest = procs // p0
    targets = [d / (i * p0 / procs) ** (1 / n) for d in dims]
    grid = _nearest_grid(dims, targets, rest)
    return p0, grid


def optimal_grid(
    dims: Sequence[int], rank: int, procs: int, mode: int = 0
) -> tuple[int, tuple[int, ...]]:
    """Exhaustive minimizer of the Alg-4 cost Eq (16) over divisor tuples.

    Beyond-paper refinement: the asymptotic rule ignores constant factors and
    integrality; for modest P an exact search is cheap (P <= 4096 has <= a few
    thousand divisor tuples for N <= 4) and strictly dominates.
    """
    n = len(dims)
    best, best_cost = None, float("inf")
    for p0 in _divisors(procs):
        if p0 > rank:
            continue
        for cand in _factorization_tuples(procs // p0, n):
            if any(c > d for c, d in zip(cand, dims)):
                continue
            c = par_general_cost(dims, rank, cand, p0, mode)
            if c < best_cost:
                best, best_cost = (p0, cand), c
    if best is None:
        return paper_grid(dims, rank, procs)
    return best


def stationary_grid(dims: Sequence[int], procs: int) -> tuple[int, ...]:
    """Alg 3 grid (P0=1): P_k ≈ I_k/(I/P)^{1/N}, rounded feasibly."""
    n = len(dims)
    i = total_size(dims)
    targets = [d / (i / procs) ** (1 / n) for d in dims]
    return _nearest_grid(dims, targets, procs)
