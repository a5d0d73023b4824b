"""Exact two-level-memory simulator for the paper's sequential model
(NumPy). Counterpart of ``repro.core.simulator``, copied: its loads, stores
and peak words must equal the reference's exactly.

The paper's sequential machine (§II-C) has a fast memory of M words and an
unbounded slow memory; communication = loads + stores. Algorithms 1 and 2
specify their loads/stores explicitly, so we *execute* them, counting every
word moved and checking that the fast-memory capacity constraint is never
violated. This is the operational validation of:

  * the Alg 1 cost  W <= I + I·R·(N+1)                   (§V-A)
  * the Alg 2 cost  W <= I + Π⌈I_k/b⌉·R·(N+1)·b          (Eq 10)
  * the feasibility condition  b^N + N·b <= M             (Eq 9)
  * the lower bounds (the simulated counts must respect Thm 4.1 / Fact 4.1).

Arithmetic is done with NumPy on the block/vector granularity the pseudocode
implies; the counters are word-exact (edge blocks counted at true size).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..engine.plan import Memory, best_uniform_block, uniform_block_feasible


@dataclass
class SimResult:
    loads: int
    stores: int
    peak_fast_words: int
    mem: int
    output: np.ndarray

    @property
    def words(self) -> int:
        return self.loads + self.stores


class _FastMemory:
    """Counts resident words and enforces the capacity M."""

    def __init__(self, mem: int):
        self.mem = mem
        self.resident = 0
        self.peak = 0

    def acquire(self, words: int) -> None:
        self.resident += words
        self.peak = max(self.peak, self.resident)
        if self.resident > self.mem:
            raise MemoryError(
                f"fast memory overflow: {self.resident} > M={self.mem}"
            )

    def release(self, words: int) -> None:
        self.resident -= words
        assert self.resident >= 0


def _resolve_mem(mem, ctx) -> int:
    """The simulated fast-memory size M (words): explicit ``mem`` wins;
    else ``ctx.memory`` (a :class:`~repro_torch.engine.plan.Memory`, whose
    word budget is the paper's abstract M)."""
    if mem is not None:
        if ctx is not None and ctx.memory is not None:
            raise ValueError(
                "pass either mem= or a ctx with a Memory, not both"
            )
        return int(mem)
    if ctx is not None and ctx.memory is not None:
        return ctx.memory.budget_words
    raise ValueError(
        "no fast-memory size: pass mem=M (words) or a ctx built with "
        "ExecutionContext.create(memory=Memory.abstract(M))"
    )


def simulate_unblocked(
    x: np.ndarray, factors: Sequence[np.ndarray], mode: int,
    mem: int | None = None, *, ctx=None,
) -> SimResult:
    """Algorithm 1 (§V-A), executed with explicit load/store counting.

    Per tensor element: 1 load of X(i); per (i, r): N-1 factor loads, one
    load and one store of B. The R-loop arithmetic is vectorized but the
    counters follow the pseudocode exactly.
    """
    mem = _resolve_mem(mem, ctx)
    n = x.ndim
    rank = next(f.shape[1] for k, f in enumerate(factors) if k != mode)
    if mem < n + 2:
        raise ValueError("M must be at least N+2 for Algorithm 1")
    fm = _FastMemory(mem)
    out = np.zeros((x.shape[mode], rank), dtype=np.float64)
    loads = stores = 0
    others = [k for k in range(n) if k != mode]
    for idx in itertools.product(*(range(s) for s in x.shape)):
        fm.acquire(1)  # load X(i)
        loads += 1
        xi = float(x[idx])
        # vectorized over r; counters per pseudocode
        prod = np.ones(rank)
        for k in others:
            prod *= factors[k][idx[k], :]
        out[idx[mode], :] += xi * prod
        loads += rank * (len(others) + 1)  # A^(k) loads + B load, each r
        stores += rank  # B store, each r
        # transient residency: x + (N-1) factor scalars + B scalar
        fm.acquire(len(others) + 2)
        fm.release(len(others) + 2)
        fm.release(1)
    return SimResult(loads, stores, fm.peak, mem, out)


def simulate_blocked(
    x: np.ndarray,
    factors: Sequence[np.ndarray],
    mode: int,
    mem: int | None = None,
    block: int | None = None,
    *,
    ctx=None,
) -> SimResult:
    """Algorithm 2 (§V-B), executed with explicit load/store counting.

    Blocks every tensor mode by ``block`` (chosen per Eq 9 if None). Per
    block: load the subtensor once; for each r, load the N-1 factor
    subvectors and load+store the output subvector. Fast-memory residency is
    tracked at true (edge-aware) sizes and must satisfy Eq (9). The M-word
    budget comes from ``mem`` or from ``ctx.memory`` (see
    :func:`_resolve_mem`).
    """
    mem = _resolve_mem(mem, ctx)
    n = x.ndim
    dims = x.shape
    rank = next(f.shape[1] for k, f in enumerate(factors) if k != mode)
    # block selection goes through the engine planner
    fast = Memory.abstract(mem)
    if block is None:
        block = best_uniform_block(dims, fast)
    if not uniform_block_feasible(n, block, fast):
        raise ValueError(f"block {block} infeasible for M={mem} (Eq 9)")
    fm = _FastMemory(mem)
    out = np.zeros((dims[mode], rank), dtype=np.float64)
    loads = stores = 0
    others = [k for k in range(n) if k != mode]

    ranges = [range(0, d, block) for d in dims]
    # einsum spec for the in-block MTTKRP
    letters = "abcdefghijklmnop"
    spec = (
        letters[:n]
        + ","
        + ",".join(f"{letters[k]}z" for k in others)
        + f"->{letters[mode]}z"
    )
    for starts in itertools.product(*ranges):
        slc = tuple(
            slice(s, min(s + block, d)) for s, d in zip(starts, dims)
        )
        blk = x[slc].astype(np.float64)
        blk_words = blk.size
        fm.acquire(blk_words)  # load block of X
        loads += blk_words
        bsl = slc[mode]
        blens = [slc[k].stop - slc[k].start for k in range(n)]
        for r in range(rank):
            # load factor subvectors
            vecs = []
            vec_words = 0
            for k in others:
                v = factors[k][slc[k], r].astype(np.float64)
                vecs.append(v)
                vec_words += v.size
            fm.acquire(vec_words)
            loads += vec_words
            # load output subvector
            fm.acquire(blens[mode])
            loads += blens[mode]
            contrib = np.einsum(spec, blk, *[v[:, None] for v in vecs])
            out[bsl, r] += contrib[:, 0]
            # store output subvector
            stores += blens[mode]
            fm.release(blens[mode] + vec_words)
        fm.release(blk_words)
    return SimResult(loads, stores, fm.peak, mem, out)
