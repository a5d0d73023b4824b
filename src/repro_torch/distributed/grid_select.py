"""Processor-grid selection against the paper's Eq (12)/Eq (16) cost models.
Counterpart of ``repro.distributed.grid_select``, copied (pure arithmetic
over the port's ``core/bounds.py`` and ``core/grid.py``): every choice and
every word count equals the reference's exactly.

* ``select_stationary_grid`` — Eq (12) minimizer over N-way grids (Alg 3),
  for a single-mode MTTKRP (``mode=k``) or for the full CP-ALS sweep
  objective (``mode=None``: the tensor stays stationary and every factor is
  gathered once and reduce-scattered once a sweep).
* ``select_general_grid``    — Eq (16) minimizer over (P_0, grid) (Alg 4).
* ``select_grid``            — the cheaper of the two (``algorithm="auto"``).
* ``choose_cp_grid``         — the CP-ALS driver's grid: the largest usable
  processor count <= P whose cost-minimal grid shards the tensor and the
  factor rows evenly, then the Eq (12) sweep-minimal grid for it.
* ``select_tucker_grid`` / ``choose_tucker_grid`` — the same search over
  the Multi-TTM/Tucker sweep objective (:func:`multi_ttm_sweep_words`).

The search is a branch-and-bound over divisor assignments
(:func:`_search_separable`); the ``brute_force_*`` functions enumerate
every divisor tuple with no pruning, as test oracles.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Sequence

from ..core.bounds import par_general_cost, par_stationary_cost
from ..core.grid import _divisors, _factorization_tuples


@dataclass(frozen=True)
class GridChoice:
    """A selected processor grid and its modeled communication."""

    p0: int
    grid: tuple[int, ...]
    words: float          # per-processor words of the selected objective
    algorithm: str        # "stationary" (Alg 3) or "general" (Alg 4)
    objective: str        # "mode{k}" or "sweep"

    @property
    def procs(self) -> int:
        return self.p0 * math.prod(self.grid)


# --------------------------------------------------------------------------
# Objectives
# --------------------------------------------------------------------------

def _alg3_factor_words(d: int, pk: int, rank: int, procs: int) -> float:
    """One Eq (12) term: moving factor k's block-rows over its hyperslice.

    ``(P/P_k - 1) * w_k`` with ``w_k = ceil(I_k/P_k) * R / (P/P_k)`` — the
    cost of one all-gather of A^(k) (or, identically, one reduce-scatter of
    B^(k)) over the q = P/P_k processors of the mode-k hyperslice.
    """
    # arithmetic mirrors bounds.par_stationary_cost term-for-term so the
    # two never disagree in the last ulp (the tests compare them exactly)
    w = math.ceil(d / pk) * rank / (procs // pk)
    return (procs / pk - 1) * w


def stationary_mode_words(
    dims: Sequence[int], rank: int, grid: Sequence[int], mode: int
) -> float:
    """Eq (12): per-processor words of one Alg-3 MTTKRP in ``mode``."""
    return par_stationary_cost(dims, rank, grid, mode)


def stationary_sweep_words(
    dims: Sequence[int],
    rank: int,
    grid: Sequence[int],
    include_solve_terms: bool = True,
) -> float:
    """Per-processor words of one stationary CP-ALS sweep (all N modes).

    The sweep driver (:mod:`repro_torch.distributed.cp_als_parallel`) keeps X
    stationary and carries each factor's gathered block-rows between mode
    updates, so per sweep every factor is all-gathered exactly once (after
    its update) and every MTTKRP output reduce-scattered exactly once:
    ``2 * sum_k (P/P_k - 1) w_k`` — versus ``N * sum_k ...`` for N
    independent Eq (12) calls.  ``include_solve_terms`` adds the R×R Gram
    all-reduces (one per mode, over the P_k-processor mode-k fiber) that the
    sharded normal-equations solve needs; they are O(R^2), asymptotically
    dominated by the factor terms.
    """
    procs = math.prod(grid)
    total = 0.0
    for d, pk in zip(dims, grid):
        total += _sweep_term(d, pk, rank, procs, include_solve_terms)
    return total


def _sweep_term(
    d: int, pk: int, rank: int, procs: int, solve: bool = True
) -> float:
    """One factor's per-sweep words (shared by the model and the search so
    their float rounding is bit-identical and tie-breaking agrees)."""
    words = 2 * _alg3_factor_words(d, pk, rank, procs)
    if solve:
        words = words + 2 * (pk - 1) / pk * rank * rank
    return words


def general_mode_words(
    dims: Sequence[int],
    rank: int,
    grid: Sequence[int],
    p0: int,
    mode: int,
) -> float:
    """Eq (16)/(28): per-processor words of one Alg-4 MTTKRP in ``mode``."""
    return par_general_cost(dims, rank, grid, p0, mode)


# --------------------------------------------------------------------------
# Feasibility (even shards)
# --------------------------------------------------------------------------

def shardable(
    dims: Sequence[int],
    rank: int,
    grid: Sequence[int],
    p0: int = 1,
) -> bool:
    """Whether the §V data distributions shard evenly on this grid.

    Delegates to :func:`repro_torch.distributed.mesh.validate_grid` (minus the
    device-count check — selection may target more processors than this
    host exposes), so the selector and the mesh layer can never disagree
    about feasibility.
    """
    from .mesh import validate_grid  # local: mesh must not import back

    try:
        validate_grid(grid, p0, dims, rank, check_devices=False)
    except ValueError:
        return False
    return True


# --------------------------------------------------------------------------
# Branch-and-bound search
# --------------------------------------------------------------------------

def _search_separable(
    dims: Sequence[int],
    procs: int,
    term: Callable[[int, int], float],
    feasible: Callable[[tuple[int, ...]], bool] | None = None,
) -> tuple[float, tuple[int, ...]] | None:
    """The shared branch-and-bound: minimize ``sum_k term(k, p_k)`` over
    all ordered divisor tuples of ``procs`` with ``p_k <= dims[k]``.

    Every objective routed here (Eq 12 single-mode, the CP-ALS sweep sum,
    the Multi-TTM/Tucker sweep sum) is a per-axis-separable sum of
    nonnegative terms, so a partial sum >= the incumbent prunes the whole
    subtree.  ``feasible`` (if given) accepts/rejects complete grids
    (even-sharding restriction)."""
    n = len(dims)
    best: tuple[float, tuple[int, ...]] | None = None

    def recurse(
        k: int, remaining: int, partial: float, acc: list[int]
    ) -> None:
        nonlocal best
        if best is not None and partial >= best[0]:
            return  # every remaining term is >= 0
        if k == n - 1:
            if remaining > dims[k]:  # degenerate: empty processors
                return
            cand = tuple(acc + [remaining])
            if feasible is not None and not feasible(cand):
                return
            cost = partial + term(k, remaining)
            if best is None or (cost, cand) < best:
                best = (cost, cand)
            return
        for d in _divisors(remaining):
            if d > dims[k]:
                continue
            recurse(k + 1, remaining // d, partial + term(k, d), acc + [d])

    recurse(0, procs, 0.0, [])
    return best


def _search_stationary(
    dims: Sequence[int],
    rank: int,
    procs: int,
    mode: int | None,
    require_divisible: bool,
) -> GridChoice | None:
    """Minimize Eq (12) (``mode=k``) or the sweep objective (``mode=None``)
    over all N-way divisor tuples of ``procs``."""

    def term(k: int, pk: int) -> float:
        if mode is None:
            return _sweep_term(dims[k], pk, rank, procs)
        return _alg3_factor_words(dims[k], pk, rank, procs)

    feasible = (
        (lambda cand: shardable(dims, rank, cand))
        if require_divisible else None
    )
    best = _search_separable(dims, procs, term, feasible)
    if best is None:
        return None
    objective = "sweep" if mode is None else f"mode{mode}"
    return GridChoice(1, best[1], best[0], "stationary", objective)


def select_stationary_grid(
    dims: Sequence[int],
    rank: int,
    procs: int,
    mode: int | None = 0,
    require_divisible: bool = False,
) -> GridChoice | None:
    """The Eq (12)-optimal Alg-3 grid for ``procs`` processors.

    ``mode=None`` optimizes the CP-ALS sweep objective
    (:func:`stationary_sweep_words`); ``require_divisible`` restricts the
    search to grids whose §V distributions shard evenly (returns ``None``
    when no such grid exists for this processor count).
    """
    return _search_stationary(
        tuple(dims), rank, procs, mode, require_divisible
    )


def select_general_grid(
    dims: Sequence[int],
    rank: int,
    procs: int,
    mode: int = 0,
    require_divisible: bool = False,
) -> GridChoice | None:
    """The Eq (16)-optimal (P_0, grid) for Alg 4 (P_0 ≤ R, pruned search)."""
    dims = tuple(dims)
    n = len(dims)
    best: tuple[float, int, tuple[int, ...]] | None = None
    for p0 in _divisors(procs):
        if p0 > rank:
            continue
        rest = procs // p0
        base = (p0 - 1) * (math.prod(dims) / procs)  # tensor all-gather term

        def term(k: int, pk: int) -> float:
            slice_sz = procs / (p0 * pk)
            if slice_sz <= 1:
                return 0.0
            w = math.ceil(dims[k] / pk) * math.ceil(rank / p0) / slice_sz
            return (slice_sz - 1) * w

        def recurse(
            k: int, remaining: int, partial: float, acc: list[int]
        ) -> None:
            nonlocal best
            if best is not None and partial >= best[0]:
                return
            if k == n - 1:
                if remaining > dims[k]:  # degenerate: empty processors
                    return
                cand = acc + [remaining]
                if require_divisible and not shardable(
                    dims, rank, cand, p0
                ):
                    return
                cost = partial + term(k, remaining)
                if best is None or (cost, p0, tuple(cand)) < best:
                    best = (cost, p0, tuple(cand))
                return
            for d in _divisors(remaining):
                if d > dims[k]:
                    continue
                recurse(
                    k + 1, remaining // d, partial + term(k, d), acc + [d]
                )

        recurse(0, rest, base, [])
    if best is None:
        return None
    return GridChoice(best[1], best[2], best[0], "general", f"mode{mode}")


def select_grid(
    dims: Sequence[int],
    rank: int,
    procs: int,
    algorithm: str = "auto",
    mode: int | None = 0,
    require_divisible: bool = False,
) -> GridChoice:
    """Grid selection entry point.

    ``algorithm="stationary"`` / ``"general"`` force Alg 3 / Alg 4;
    ``"auto"`` returns whichever attains the lower modeled cost — the exact
    form of the paper's Cor 4.2 NR-threshold regime decision.  The sweep
    objective (``mode=None``) is stationary-only (Alg 4 moves the tensor,
    which a CP-ALS sweep never should per arXiv:1806.07985).
    """
    if algorithm not in ("auto", "stationary", "general"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if mode is None and algorithm == "general":
        raise ValueError("the sweep objective is stationary-only (Alg 3)")
    stat = (
        select_stationary_grid(dims, rank, procs, mode, require_divisible)
        if algorithm in ("auto", "stationary")
        else None
    )
    gen = (
        select_general_grid(dims, rank, procs, mode, require_divisible)
        if algorithm in ("auto", "general") and mode is not None
        else None
    )
    candidates = [c for c in (stat, gen) if c is not None]
    if not candidates:
        raise ValueError(
            f"no feasible grid for dims={tuple(dims)}, P={procs}"
            + (" with even sharding" if require_divisible else "")
        )
    return min(candidates, key=lambda c: (c.words, c.algorithm))


def choose_cp_grid(
    dims: Sequence[int], rank: int, procs: int
) -> GridChoice:
    """Grid for the distributed CP-ALS sweep driver.

    Uses the largest processor count ≤ ``procs`` that admits an evenly-
    sharding grid (more processors shrink the per-processor tensor block —
    communication is secondary to using the machine), then the Eq (12)
    sweep-minimal grid among them.  Always succeeds: P=1 shards trivially.
    """
    for p in range(procs, 0, -1):
        choice = select_stationary_grid(
            dims, rank, p, mode=None, require_divisible=True
        )
        if choice is not None:
            return choice
    raise AssertionError("unreachable: P=1 always shards evenly")


# --------------------------------------------------------------------------
# Multi-TTM / Tucker (arXiv:2207.10437): sweep objective + grid selection
# --------------------------------------------------------------------------

def _rank_complement_products(ranks: Sequence[int]) -> list[int]:
    """R-bar_k = prod_{j != k} R_j for every mode."""
    total = math.prod(ranks)
    return [total // r for r in ranks]


def _tucker_term(d: int, pk: int, rbar: int, procs: int) -> float:
    """One mode's per-sweep words in the stationary-tensor Tucker/HOOI
    sweep (:mod:`.tucker_parallel`): the partial Y^(k) block-rows are
    all-reduced over the mode-k hyperslice (``2(q-1)/q * w`` with
    ``q = P/p_k``) and then all-gathered over the
    mode-k fiber (``(p_k-1) * w``), where ``w = ceil(I_k/p_k) * R-bar_k``
    is one processor's block of the kept-mode rows times the Kronecker
    rank of the other modes.  Factor matrices travel nowhere: the
    replicated eigenvector update leaves every processor holding all of
    A^(k), so there is no Eq-12-style gather term."""
    q = procs // pk
    w = math.ceil(d / pk) * rbar
    return (2 * (q - 1) / q + (pk - 1)) * w


def multi_ttm_sweep_words(
    dims: Sequence[int], ranks: Sequence[int], grid: Sequence[int]
) -> float:
    """Per-processor words of one Tucker/HOOI sweep (all N mode updates)
    on the stationary-tensor distribution — the Multi-TTM analog of
    :func:`stationary_sweep_words`, and the objective
    :func:`select_tucker_grid` minimizes."""
    procs = math.prod(grid)
    rbars = _rank_complement_products(ranks)
    total = 0.0
    for d, pk, rbar in zip(dims, grid, rbars):
        total += _tucker_term(d, pk, rbar, procs)
    return total


def tucker_shardable(dims: Sequence[int], grid: Sequence[int]) -> bool:
    """Whether the Tucker stationary distribution shards evenly
    (delegates to :func:`repro_torch.distributed.mesh.validate_tucker_grid`,
    minus the device-count check)."""
    from .mesh import validate_tucker_grid  # local: mesh must not import back

    try:
        validate_tucker_grid(grid, dims, check_devices=False)
    except ValueError:
        return False
    return True


def select_tucker_grid(
    dims: Sequence[int],
    ranks: Sequence[int],
    procs: int,
    require_divisible: bool = False,
) -> GridChoice | None:
    """The grid minimizing the Multi-TTM sweep objective for ``procs``
    processors — the same branch-and-bound as the CP selectors, run over
    :func:`multi_ttm_sweep_words`'s per-axis terms."""
    dims = tuple(dims)
    ranks = tuple(ranks)
    rbars = _rank_complement_products(ranks)

    def term(k: int, pk: int) -> float:
        return _tucker_term(dims[k], pk, rbars[k], procs)

    feasible = (
        (lambda cand: tucker_shardable(dims, cand))
        if require_divisible else None
    )
    best = _search_separable(dims, procs, term, feasible)
    if best is None:
        return None
    return GridChoice(1, best[1], best[0], "tucker", "sweep")


def choose_tucker_grid(
    dims: Sequence[int], ranks: Sequence[int], procs: int
) -> GridChoice:
    """Grid for the distributed Tucker/HOOI sweep driver: the largest
    processor count ≤ ``procs`` admitting an evenly-sharding grid, then
    the sweep-minimal grid among them (the Multi-TTM mirror of
    :func:`choose_cp_grid`).  Always succeeds: P=1 shards trivially."""
    for p in range(procs, 0, -1):
        choice = select_tucker_grid(dims, ranks, p, require_divisible=True)
        if choice is not None:
            return choice
    raise AssertionError("unreachable: P=1 always shards evenly")


def brute_force_tucker(
    dims: Sequence[int],
    ranks: Sequence[int],
    procs: int,
    require_divisible: bool = False,
) -> GridChoice | None:
    """Exhaustive Multi-TTM sweep minimum over every ordered divisor
    tuple (test oracle for :func:`select_tucker_grid`; no pruning)."""
    best: tuple[float, tuple[int, ...]] | None = None
    for cand in _factorization_tuples(procs, len(dims)):
        if any(c > d for c, d in zip(cand, dims)):
            continue
        if require_divisible and not tucker_shardable(dims, cand):
            continue
        cost = multi_ttm_sweep_words(dims, ranks, cand)
        if best is None or (cost, cand) < best:
            best = (cost, cand)
    if best is None:
        return None
    return GridChoice(1, best[1], best[0], "tucker", "sweep")


# --------------------------------------------------------------------------
# Brute-force references (test oracles: no pruning, plain enumeration)
# --------------------------------------------------------------------------

def brute_force_stationary(
    dims: Sequence[int],
    rank: int,
    procs: int,
    mode: int | None = 0,
    require_divisible: bool = False,
) -> GridChoice | None:
    """Exhaustive Eq (12)/sweep minimum over every ordered divisor tuple."""
    best: tuple[float, tuple[int, ...]] | None = None
    for cand in _factorization_tuples(procs, len(dims)):
        if any(c > d for c, d in zip(cand, dims)):
            continue
        if require_divisible and not shardable(dims, rank, cand):
            continue
        cost = (
            stationary_sweep_words(dims, rank, cand)
            if mode is None
            else par_stationary_cost(dims, rank, cand, mode)
        )
        if best is None or (cost, cand) < best:
            best = (cost, cand)
    if best is None:
        return None
    objective = "sweep" if mode is None else f"mode{mode}"
    return GridChoice(1, best[1], best[0], "stationary", objective)


def brute_force_general(
    dims: Sequence[int],
    rank: int,
    procs: int,
    mode: int = 0,
    require_divisible: bool = False,
) -> GridChoice | None:
    """Exhaustive Eq (16) minimum over every (P_0 ≤ R, divisor tuple)."""
    best: tuple[float, int, tuple[int, ...]] | None = None
    for p0 in _divisors(procs):
        if p0 > rank:
            continue
        for cand in _factorization_tuples(procs // p0, len(dims)):
            if any(c > d for c, d in zip(cand, dims)):
                continue
            if require_divisible and not shardable(dims, rank, cand, p0):
                continue
            cost = par_general_cost(dims, rank, cand, p0, mode)
            if best is None or (cost, p0, cand) < best:
                best = (cost, p0, cand)
    if best is None:
        return None
    return GridChoice(best[1], best[2], best[0], "general", f"mode{mode}")
