"""Every communication lower bound and algorithm cost formula in the paper.

A verbatim copy of ``repro.core.bounds`` (pure Python, no framework): the
port keeps its own copy so that it never imports the JAX package. The
parity test pins every function against the reference over a lattice.

All functions count *words* (the paper's unit); callers multiply by
``dtype.itemsize`` for bytes. Dimensions are 0-based tuples ``dims = (I_1,
..., I_N)``; ``I = prod(dims)``; ``R`` is the CP rank; ``M`` the fast/local
memory in words; ``P`` the processor count.

Paper map
---------
=====================  =====================================================
``seq_lb_memory``       Theorem 4.1  (Eq 4 / Eq 21)
``seq_lb_trivial``      Fact 4.1     (Eq 5 / Eq 22)
``par_lb_memory``       Corollary 4.1
``par_lb_general``      Theorem 4.2  (Eq 29)
``par_lb_stationary``   Theorem 4.3  (Eq 30)
``par_lb_combined``     Corollary 4.2 (sum form, cubical tensors)
``seq_unblocked_cost``  §V-A upper bound  W <= I + IR(N+1)
``seq_blocked_cost``    §V-B Eq (10) / Eq (19)
``blocked_feasible_b``  Eq (9)/(20):  b^N + N b <= M
``best_block_size``     largest feasible b (the paper picks b ≈ (αM)^{1/N})
``par_stationary_cost`` §V-C3 Eq (12)  (Alg 3)
``par_general_cost``    §V-D3 Eq (16)/(28)  (Alg 4)
``matmul_seq_cost``     §VI-A baseline  O(I + IR/sqrt(M))
``matmul_par_cost``     §VI-B baseline (rectangular matmul, small/large P)
=====================  =====================================================

Multi-TTM (the Tucker/HOSVD kernel, arXiv:2207.10437) has its own section
below: ``multi_ttm_seq_lb_*`` (the HBL memory bound and the trivial I/O
bound), ``multi_ttm_{un,}blocked_cost`` + ``multi_ttm_blocked_feasible_b``
(the Eq-9/Eq-10 analogs the engine's ``MultiTTMPlan`` is pinned against),
and ``par_multi_ttm_cost`` (the stationary-tensor parallel cost).
"""

from __future__ import annotations

import math
from typing import Sequence

from .tensor import total_size


# --------------------------------------------------------------------------
# Sequential lower bounds
# --------------------------------------------------------------------------

def seq_lb_memory(dims: Sequence[int], rank: int, mem: int) -> float:
    """Theorem 4.1: W >= N·I·R / 3^(2-1/N) / M^(1-1/N) - M."""
    n = len(dims)
    i = total_size(dims)
    return n * i * rank / (3 ** (2 - 1 / n)) / (mem ** (1 - 1 / n)) - mem


def seq_lb_trivial(dims: Sequence[int], rank: int, mem: int) -> float:
    """Fact 4.1: W >= I + sum_k I_k R - 2M (must touch all inputs/outputs)."""
    return total_size(dims) + sum(dims) * rank - 2 * mem


def seq_lb(dims: Sequence[int], rank: int, mem: int) -> float:
    """max of the two sequential bounds (never negative)."""
    return max(
        seq_lb_memory(dims, rank, mem), seq_lb_trivial(dims, rank, mem), 0.0
    )


# --------------------------------------------------------------------------
# Parallel lower bounds
# --------------------------------------------------------------------------

def par_lb_memory(dims: Sequence[int], rank: int, procs: int, mem: int) -> float:
    """Corollary 4.1: per-processor words >= Thm4.1 numerator / P."""
    n = len(dims)
    i = total_size(dims)
    return n * i * rank / (3 ** (2 - 1 / n)) / (procs * mem ** (1 - 1 / n)) - mem


def par_lb_general(
    dims: Sequence[int],
    rank: int,
    procs: int,
    gamma: float = 1.0,
    delta: float = 1.0,
) -> float:
    """Theorem 4.2 (Eq 29): 2(NIR/P)^{N/(2N-1)} - γI/P - δ Σ I_k R / P."""
    n = len(dims)
    i = total_size(dims)
    return (
        2 * (n * i * rank / procs) ** (n / (2 * n - 1))
        - gamma * i / procs
        - delta * sum(dims) * rank / procs
    )


def par_lb_stationary(
    dims: Sequence[int],
    rank: int,
    procs: int,
    gamma: float = 1.0,
    delta: float = 1.0,
) -> float:
    """Theorem 4.3 (Eq 30)."""
    n = len(dims)
    i = total_size(dims)
    term_a = (
        math.sqrt(2 / (3 * gamma)) * n * rank * (i / procs) ** (1 / n)
        - delta * sum(dims) * rank / procs
    )
    term_b = gamma * i / (2 * procs)
    return min(term_a, term_b)


def par_lb_combined(dims: Sequence[int], rank: int, procs: int) -> float:
    """Corollary 4.2 asymptotic form (sum of the two regimes' bounds).

    Stated for cubical tensors; we evaluate the sum form with unit constants
    as the reference lower-bound curve for the benchmarks.
    """
    n = len(dims)
    i = total_size(dims)
    return (n * i * rank / procs) ** (n / (2 * n - 1)) + n * rank * (
        i / procs
    ) ** (1 / n)


def nr_threshold_regime(dims: Sequence[int], rank: int, procs: int) -> str:
    """Which Cor 4.2 regime applies: 'rank' when NR > (I/P)^{1-1/N} (Thm 4.2
    dominates, Alg 4 with P0>1 needed) else 'stationary' (Alg 3 optimal)."""
    n = len(dims)
    i = total_size(dims)
    return "rank" if n * rank > (i / procs) ** (1 - 1 / n) else "stationary"


# --------------------------------------------------------------------------
# Sequential algorithm costs (upper bounds)
# --------------------------------------------------------------------------

def seq_unblocked_cost(dims: Sequence[int], rank: int) -> float:
    """§V-A: Algorithm 1 cost W <= I + I·R·(N+1)."""
    n = len(dims)
    i = total_size(dims)
    return i + i * rank * (n + 1)


def seq_blocked_cost(dims: Sequence[int], rank: int, block: int) -> float:
    """§V-B Eq (10)/(19): I + prod_k ceil(I_k/b) · R(N+1)·b."""
    n = len(dims)
    i = total_size(dims)
    nblocks = 1
    for d in dims:
        nblocks *= math.ceil(d / block)
    return i + nblocks * rank * (n + 1) * block


def blocked_feasible_b(n: int, block: int, mem: int) -> bool:
    """Eq (9)/(20): b^N + N·b <= M."""
    return block ** n + n * block <= mem


def best_block_size(dims: Sequence[int], mem: int) -> int:
    """Largest b with b^N + Nb <= M (paper: b ≈ (αM)^{1/N}); at least 1."""
    n = len(dims)
    b = max(1, int(mem ** (1.0 / n)))
    while b > 1 and not blocked_feasible_b(n, b, mem):
        b -= 1
    while blocked_feasible_b(n, b + 1, mem):
        b += 1
    return max(1, b)


def matmul_seq_cost(dims: Sequence[int], rank: int, mem: int, mode: int = 0) -> float:
    """§VI-A: MTTKRP via comm-optimal matmul: O(I + IR/sqrt(M)).

    (I_n x I/I_n) @ (I/I_n x R); classic matmul bound 2*prod/sqrt(M) plus
    touching inputs/outputs once. KRP formation cost (sum_{k!=n} I_k R reads,
    I/I_n * R writes) is charged: the explicit KRP must be written to slow
    memory when it exceeds M.
    """
    i = total_size(dims)
    i_n = dims[mode]
    other = i // i_n
    krp_form = sum(d for k, d in enumerate(dims) if k != mode) * rank + other * rank
    mm = 2.0 * i * rank / math.sqrt(mem) + i + other * rank + i_n * rank
    return krp_form + mm


# --------------------------------------------------------------------------
# Parallel algorithm costs (upper bounds)
# --------------------------------------------------------------------------

def par_stationary_cost(
    dims: Sequence[int], rank: int, grid: Sequence[int], mode: int = 0
) -> float:
    """§V-C3 Eq (12): per-processor words for Algorithm 3.

    sum_k (P/P_k - 1) * w_k, where w_k = max_p nnz(A_p^{(k)}) = I_k R / P for
    the load-balanced block-row distribution (factor k's rows are spread over
    the whole hyperslice of P/P_k processors, each holding I_k/P_k rows / the
    (P/P_k)-fold partition => I_k R / P entries each).
    """
    procs = 1
    for g in grid:
        procs *= g
    total = 0.0
    for k, (d, pk) in enumerate(zip(dims, grid)):
        w = math.ceil(d / pk) * rank / (procs // pk)
        total += (procs / pk - 1) * w
    return total


def par_general_cost(
    dims: Sequence[int],
    rank: int,
    grid: Sequence[int],
    p0: int,
    mode: int = 0,
) -> float:
    """§V-D3 Eq (16)/(28): per-processor words for Algorithm 4.

    (P0-1)*nnz(X_p) + sum_k (P/(P0 Pk) - 1) * w_k with the load-balanced
    distribution nnz(X_p)=I/P, w_k = I_k/P_k * R/P0 / (P/(P_k P0)).
    """
    procs = p0
    for g in grid:
        procs *= g
    i = total_size(dims)
    total = (p0 - 1) * (i / procs)
    for k, (d, pk) in enumerate(zip(dims, grid)):
        slice_sz = procs / (p0 * pk)
        w = math.ceil(d / pk) * math.ceil(rank / p0) / slice_sz
        total += (slice_sz - 1) * w
    return total


# --------------------------------------------------------------------------
# Multi-TTM (Tucker/HOSVD kernel) bounds and costs — arXiv:2207.10437
# --------------------------------------------------------------------------
#
# Multi-TTM contracts an N-way tensor X (I_1 x ... x I_N) with matrices
# A^(k) (I_k x R_k) along every mode (the Tucker core G = X x_1 A_1^T ...
# x_N A_N^T) or along every mode but one (the HOOI workhorse
# Y^(k) = X x_{j != k} A_j^T).  Al Daas, Ballard, Grigori, Kumar & Rouse
# (arXiv:2207.10437) prove the analogous communication lower bounds and
# optimal algorithms; the functions below are the repo's oracle for them,
# in the same canonical form the engine plans: ``dims`` are the tensor
# extents of the *contraction problem* (kept mode first), ``ranks`` are
# the small dimensions R_d of the contracted modes only.

def multi_ttm_seq_lb_memory(
    dims: Sequence[int], ranks: Sequence[int], mem: int
) -> float:
    """Memory-dependent sequential Multi-TTM lower bound (HBL form).

    The atomic computation is a (N + k)-dimensional loop nest of
    I * R = prod(dims) * prod(ranks) multiplies; the HBL/Loomis-Whitney
    exponents covering every loop index with the tensor (s=1/2), the
    output (s=1/2), and each matrix (s=1/2) give per-segment ops
    <= (2M)^{(k+2)/2} for k contracted modes, hence
    W >= I*R*M / (2M)^{(k+2)/2} - M (the arXiv:2207.10437 Sec. 3
    argument; for k = 1 this is the classical matmul bound
    I*R / (2M)^{1/2} up to the additive M)."""
    k = len(ranks)
    ops = total_size(dims) * total_size(ranks)
    return ops * mem / (2 * mem) ** ((k + 2) / 2) - mem


def multi_ttm_seq_lb_trivial(
    dims: Sequence[int], ranks: Sequence[int], mem: int
) -> float:
    """Trivial Multi-TTM I/O bound: touch X once, every matrix once, and
    the output once — W >= I + sum_d C_d R_d + I_keep * prod(ranks) - 2M
    (``dims[0]`` is the kept mode; ``dims[1:]`` pair with ``ranks``)."""
    mats = sum(c * r for c, r in zip(dims[1:], ranks))
    out = dims[0] * total_size(ranks)
    return total_size(dims) + mats + out - 2 * mem


def multi_ttm_seq_lb(
    dims: Sequence[int], ranks: Sequence[int], mem: int
) -> float:
    """max of the two sequential Multi-TTM bounds (never negative)."""
    return max(
        multi_ttm_seq_lb_memory(dims, ranks, mem),
        multi_ttm_seq_lb_trivial(dims, ranks, mem),
        0.0,
    )


def multi_ttm_unblocked_cost(
    dims: Sequence[int], ranks: Sequence[int]
) -> float:
    """Unblocked Multi-TTM upper bound (Algorithm-1 analog): per tensor
    entry, read one row of each matrix (sum_d R_d) and update the output
    subrow (2 * prod(ranks)): W <= I + I*(sum R_d + 2 prod R_d)."""
    i = total_size(dims)
    return i + i * (sum(ranks) + 2 * total_size(ranks))


def multi_ttm_blocked_cost(
    dims: Sequence[int], ranks: Sequence[int], block: int
) -> float:
    """Blocked Multi-TTM cost (the Eq-10 analog, arXiv:2207.10437 Sec. 5).

    One pass over the tensor, plus per b^N block: the matrix subblocks
    (b rows of each contracted matrix, b * sum R_d words) and one
    load+store of the output subblock (2 * b * prod R_d — the kept-mode
    rows of this block times the full Kronecker rank):
    W = I + prod_k ceil(I_k/b) * b * (sum R_d + 2 prod R_d)."""
    i = total_size(dims)
    nblocks = 1
    for d in dims:
        nblocks *= math.ceil(d / block)
    return i + nblocks * block * (sum(ranks) + 2 * total_size(ranks))


def multi_ttm_blocked_feasible_b(
    ndim: int, ranks: Sequence[int], block: int, mem: int
) -> bool:
    """Eq-9 analog for Multi-TTM: the blocked working set
    b^N (tensor tile) + b*sum R_d (matrix tiles) + b^{N-1}*prod R_d
    (Kronecker weight block) + b*prod R_d (output tile) must fit in M."""
    r = 1
    for x in ranks:
        r *= x
    ws = (
        block ** ndim
        + block * sum(ranks)
        + block ** (ndim - 1) * r
        + block * r
    )
    return ws <= mem


def multi_ttm_best_block_size(
    dims: Sequence[int], ranks: Sequence[int], mem: int
) -> int:
    """Largest uniform b feasible per :func:`multi_ttm_blocked_feasible_b`
    (at least 1 — callers check feasibility of the b=1 working set)."""
    n = len(dims)
    b = max(1, int(mem ** (1.0 / n)))
    while b > 1 and not multi_ttm_blocked_feasible_b(n, ranks, b, mem):
        b -= 1
    while multi_ttm_blocked_feasible_b(n, ranks, b + 1, mem):
        b += 1
    return max(1, b)


def par_multi_ttm_cost(
    dims: Sequence[int], ranks: Sequence[int], grid: Sequence[int]
) -> float:
    """Per-processor words of the stationary-tensor parallel Multi-TTM
    computing the full core on an N-way grid (arXiv:2207.10437 Sec. 5
    specialized to our X-stationary distribution): gather each matrix's
    block-rows over its mode hyperslice (the Eq-12-shaped terms), then
    all-reduce the local partial core (2(P-1)/P * prod R_k words)."""
    procs = 1
    for g in grid:
        procs *= g
    total = 0.0
    for d, pk, r in zip(dims, grid, ranks):
        w = math.ceil(d / pk) * r / (procs // pk)
        total += (procs / pk - 1) * w
    core = 1
    for r in ranks:
        core *= r
    return total + 2 * (procs - 1) / procs * core


def matmul_par_cost(dims: Sequence[int], rank: int, procs: int) -> float:
    """§VI-B: comm-optimal rectangular matmul cost for X_(n) @ KRP.

    Uses the Demmel et al. [10] three-regime model for multiplying
    (I_n x K) @ (K x R), K = I/I_n, with the paper's extreme cases:
    one large dimension (P <= K/max(I_n,R)... simplified): cost I^{1/N} R for
    small P; (I R / P)^{2/3} for large P; plus the (ignored by the paper,
    also ignored here) KRP formation communication.
    """
    i = total_size(dims)
    i_n = dims[0]
    small_p = i_n * rank  # one-large-dim regime: communicate the small matrices
    large_p = (i * rank / procs) ** (2 / 3)
    # The applicable regime is the cheaper valid one; the paper compares
    # extremes, we return the min as the strongest baseline.
    return max(min(small_p, large_p), i / procs)  # must at least read tensor


__all__ = [n for n in dir() if not n.startswith("_")]
