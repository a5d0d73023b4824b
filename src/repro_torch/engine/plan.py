"""The planner: one source of truth for MTTKRP blocking and traffic models.

Counterpart of ``repro.engine.plan``:

  * :class:`Memory` — an explicit two-level-memory descriptor (capacity,
    lane/sublane alignment, itemsize). ``Memory.h100_smem()`` is the shared
    memory one CUDA thread block (CTA) of the Hopper kernels blocks
    against; ``Memory.tpu_vmem()`` is the reference's TPU VMEM, kept so the
    port's planner can be pinned against the reference's plans;
    ``Memory.abstract(M)`` is the paper's §II-C abstract M-word memory.
  * :class:`BlockPlan` — block sizes for one contraction, with the Eq-9
    working-set check and the Eq-10 traffic model as methods.
  * :func:`choose_blocks` — aligned block selection against a Memory
    budget, unchanged from the reference: under ``Memory.tpu_vmem()`` it
    returns exactly the reference's plans; :func:`batched_choose_blocks`,
    the plan of a batch, is the element's.
  * :func:`choose_sweep_blocks` (with :func:`fused_pair_working_set_words`)
    — the fused (B0, P) pair's plan, unchanged from the reference.
  * :func:`mttkrp_traffic_model` — the functional spelling of
    :meth:`BlockPlan.traffic_model`, as the reference exports it.
  * :func:`best_uniform_block` / :func:`uniform_block_feasible` /
    :func:`uniform_plan` — the paper's exact uniform-b selection (Eq 9).
  * :class:`MultiTTMPlan`, :func:`choose_multi_ttm_blocks`,
    :func:`uniform_multi_ttm_plan` — the Multi-TTM (Tucker) planner,
    unchanged from the reference.
  * The Hopper kernels' own plans, chosen against their real shared
    memory: :class:`MTTKRPKernelPlan` (:func:`choose_mttkrp_kernel_blocks`)
    for the MTTKRP kernel and, with :func:`choose_pair_kernel_blocks`, the
    fused pair kernel; :class:`MultiTTMKernelPlan`
    (:func:`choose_multi_ttm_kernel_blocks`) for the Multi-TTM kernel;
    :class:`PartialKernelPlan` (:func:`choose_partial_kernel_blocks`, from
    the node's strides) for the streaming partial kernel.

:func:`keep_first` gives a problem's canonical shape (the output or kept
mode first). Formula provenance stays in :mod:`repro_torch.core.bounds`.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Sequence

from ..core.bounds import (
    best_block_size,
    blocked_feasible_b,
    multi_ttm_best_block_size,
    multi_ttm_blocked_cost,
    seq_blocked_cost,
)

LANE = 128
SUBLANE = 8
VMEM_BYTES = 16 * 2 ** 20  # the reference's TPU (v5e) per-core VMEM
VMEM_BUDGET = VMEM_BYTES // 2  # the reference leaves double-buffer headroom

#: Hopper: a warp is 32 threads (the lane unit of a CTA's output tile);
#: the kernels' row unit is 8 (one warp's register tile is 8 rows).
SMEM_LANE = 32
SMEM_SUBLANE = 8
#: An H100 SM has 228 KiB of shared memory; one CTA may take at most
#: 227 KiB (232,448 bytes) of it, and the system reserves 1 KiB per CTA.
SMEM_PER_SM = 228 * 1024
SMEM_PER_CTA_MAX = 232_448
#: The planning budget: the largest per-CTA budget with which two CTAs
#: (each plus its 1 KiB reserve) still fit one SM, so that one CTA's loads
#: overlap the other's arithmetic. 2 * (115,712 + 1,024) = 233,472 bytes.
SMEM_BUDGET = SMEM_PER_SM // 2 - 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def keep_first(shape: Sequence[int], lead: int) -> tuple[int, ...]:
    """``shape`` with axis ``lead`` first and the rest in order: a problem's
    canonical shape (the output mode of an MTTKRP, the kept mode of a
    Multi-TTM, mode 0 for the full core)."""
    shape = tuple(shape)
    return (shape[lead],) + shape[:lead] + shape[lead + 1:]


@dataclass(frozen=True)
class Memory:
    """Two-level fast-memory descriptor the planner blocks against."""

    budget_bytes: int
    lane: int = 1
    sublane: int = 1
    itemsize: int = 4

    @classmethod
    def h100_smem(cls, budget_bytes: int = SMEM_BUDGET, itemsize: int = 4) -> "Memory":
        """The Hopper kernels' fast memory: one CTA's shared memory, with
        warp-width (32) lanes and 8-row sublanes. The default budget lets
        two CTAs share an SM; it may not exceed 232,448 bytes."""
        if not 0 < budget_bytes <= SMEM_PER_CTA_MAX:
            raise ValueError(
                f"an H100 CTA can use at most {SMEM_PER_CTA_MAX} bytes of "
                f"shared memory, got budget_bytes={budget_bytes}"
            )
        return cls(budget_bytes, lane=SMEM_LANE, sublane=SMEM_SUBLANE, itemsize=itemsize)

    @classmethod
    def tpu_vmem(cls, budget_bytes: int = VMEM_BUDGET, itemsize: int = 4) -> "Memory":
        """The reference's Pallas fast memory: VMEM with MXU alignment."""
        return cls(budget_bytes, lane=LANE, sublane=SUBLANE, itemsize=itemsize)

    @classmethod
    def abstract(cls, words: int, itemsize: int = 1) -> "Memory":
        """The paper's abstract M-word fast memory (§II-C): no alignment."""
        return cls(words * itemsize, lane=1, sublane=1, itemsize=itemsize)

    @property
    def budget_words(self) -> int:
        return self.budget_bytes // self.itemsize

    def with_itemsize(self, itemsize: int) -> "Memory":
        """Same memory, re-described for a different element width: a bf16
        compute dtype halves ``itemsize`` so ``budget_words`` doubles."""
        if itemsize == self.itemsize:
            return self
        return Memory(self.budget_bytes, self.lane, self.sublane, itemsize)


@dataclass(frozen=True)
class BlockPlan:
    """Block sizes for one (possibly rank-augmented) MTTKRP-shaped
    contraction: output rows ``block_i``, contraction dims
    ``block_contract``, rank tile ``block_r``.

    ``x_has_rank`` marks dimension-tree partial contractions whose tensor
    operand already carries the rank axis.
    """

    block_i: int
    block_contract: tuple[int, ...]
    block_r: int
    x_has_rank: bool = False

    # -- Eq 9: working set -------------------------------------------------
    def kernel_block_words(self) -> int:
        """Words of the operand tiles alone: X tile + factor tiles + output
        tile."""
        prod_c = math.prod(self.block_contract)
        x_tile = self.block_i * prod_c * (self.block_r if self.x_has_rank else 1)
        f_tiles = sum(c * self.block_r for c in self.block_contract)
        out = self.block_i * self.block_r
        return x_tile + f_tiles + out

    def weight_scratch_words(self) -> int:
        """Words of the Khatri-Rao weight block ``prod(bc) * br`` the kernel
        builds on chip each step (it never touches device memory)."""
        return math.prod(self.block_contract) * self.block_r

    def working_set_words(self, itemsize: int = 4) -> int:
        """Fast-memory words held per step (Eq 9 analogue): X tile + factor
        tiles + KRP block + output tile."""
        del itemsize  # word count is itemsize-free; kept for API parity
        return self.kernel_block_words() + self.weight_scratch_words()

    def fits(self, memory: Memory) -> bool:
        """Eq-9 feasibility against an explicit memory descriptor."""
        return self.working_set_words() * memory.itemsize <= memory.budget_bytes

    # -- shapes ------------------------------------------------------------
    def blocks_per_mode(self) -> tuple[int, ...]:
        """Per-mode block sizes with the output mode first (paper's b_k)."""
        return (self.block_i,) + tuple(self.block_contract)

    def padded_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """Input shape rounded up to block multiples (output mode first)."""
        blocks = self.blocks_per_mode()
        return tuple(_round_up(s, b) for s, b in zip(shape, blocks))

    def grid(self, shape: Sequence[int], rank: int) -> tuple[int, ...]:
        """Tile grid (r, i, c_1..c_{N-1}) of the padded problem."""
        padded = self.padded_shape(shape)
        r_pad = _round_up(rank, self.block_r)
        return (r_pad // self.block_r, padded[0] // self.block_i) + tuple(
            padded[1 + d] // self.block_contract[d]
            for d in range(len(self.block_contract))
        )

    # -- Eq 10: traffic ----------------------------------------------------
    def eq10_words(self, shape: Sequence[int], rank: int) -> int:
        """The paper's Eq (10) bound generalized to per-mode block sizes;
        with a uniform block b it is ``core.bounds.seq_blocked_cost``."""
        blocks = self.blocks_per_mode()
        nblocks = math.prod(math.ceil(s / b) for s, b in zip(shape, blocks))
        per_block = rank * (sum(blocks) + blocks[0])
        return math.prod(shape) + nblocks * per_block

    def traffic_model(
        self, shape: Sequence[int], rank: int, itemsize: int = 4
    ) -> dict[str, int]:
        """Modeled slow<->fast memory traffic (bytes) of the reference's
        tile schedule: X fetched every step, factor d re-fetched when
        (c_d, r) changes, O written once per (i, r). ``eq10_bytes`` is the
        paper-ideal Eq-10 cost for the same per-mode block sizes."""
        n = len(shape)
        padded = self.padded_shape(shape)
        r_pad = _round_up(rank, self.block_r)
        gi = padded[0] // self.block_i
        gr = r_pad // self.block_r
        gc = [padded[1 + d] // self.block_contract[d] for d in range(n - 1)]
        steps = gi * gr * math.prod(gc)
        x_words = self.block_i * math.prod(self.block_contract)
        if self.x_has_rank:
            x_words *= self.block_r
        x_bytes = steps * x_words * itemsize
        f_bytes = 0
        run = gi * gr
        for d in range(n - 1):
            run *= gc[d]
            f_bytes += run * self.block_contract[d] * self.block_r * itemsize
        o_bytes = gi * gr * self.block_i * self.block_r * itemsize
        total = x_bytes + f_bytes + o_bytes
        return {
            "x_bytes": x_bytes,
            "factor_bytes": f_bytes,
            "out_bytes": o_bytes,
            "total_bytes": total,
            "eq10_bytes": self.eq10_words(shape, rank) * itemsize,
            "steps": steps,
            "working_set_bytes": self.working_set_words() * itemsize,
        }


def choose_blocks(
    shape: Sequence[int],
    rank: int,
    itemsize: int = 4,
    vmem_budget: int = VMEM_BUDGET,
    *,
    memory: Memory | None = None,
    x_has_rank: bool = False,
) -> BlockPlan:
    """Pick aligned block sizes fitting the memory budget (the reference's
    algorithm, unchanged).

    Output mode and rank tiles start at 128 and 512, the minor contraction
    dim at 128 (lane-aligned), other contraction dims at the sublane unit;
    then the largest contributor shrinks (rank, output rows, non-minor
    contraction dims, the minor dim) until the working set fits. A
    dimension smaller than its alignment unit gets its full extent. If even
    the aligned-minimal plan exceeds the budget, alignment is relaxed.

    ``memory=None`` keeps the reference's default (the TPU VMEM descriptor
    built from ``vmem_budget``); the port's kernel wrappers pass
    ``Memory.h100_smem()``.
    """
    if memory is None:
        memory = Memory.tpu_vmem(vmem_budget, itemsize)
    lane, sublane = memory.lane, memory.sublane
    n = len(shape)

    def start(extent: int, unit: int, pref: int) -> int:
        if extent <= unit:  # sub-unit dim: full extent, zero padding
            return max(1, extent)
        return min(_round_up(extent, unit), pref)

    def floor(extent: int, unit: int) -> int:
        return max(1, extent) if extent <= unit else unit

    bi = start(shape[0], sublane, 128)
    br = start(rank, lane, 512)
    bc: list[int] = []
    for d in range(1, n):
        if d == n - 1:  # minor dim: lane-aligned
            bc.append(start(shape[d], lane, 128))
        else:
            bc.append(start(shape[d], sublane, max(sublane, 8)))
    fi = floor(shape[0], sublane)
    fr = floor(rank, lane)
    fc = [floor(shape[d], lane if d == n - 1 else sublane) for d in range(1, n)]
    plan = BlockPlan(bi, tuple(bc), br, x_has_rank)
    while not plan.fits(memory):
        bi, br = plan.block_i, plan.block_r
        bc = list(plan.block_contract)
        if br > fr:
            br = max(fr, br // 2)
        elif bi > fi:
            bi = max(fi, bi // 2)
        else:
            shrunk = False
            for d in range(len(bc) - 1):  # shrink non-minor contraction dims
                if bc[d] > fc[d]:
                    bc[d] = max(fc[d], bc[d] // 2)
                    shrunk = True
                    break
            if not shrunk:
                if bc and bc[-1] > fc[-1]:
                    bc[-1] = max(fc[-1], bc[-1] // 2)
                else:
                    break  # aligned floors reached; relax below
        plan = BlockPlan(bi, tuple(bc), br, x_has_rank)
    # last resort: relax alignment (largest contributor first)
    while not plan.fits(memory):
        dims = [plan.block_i, *plan.block_contract, plan.block_r]
        j = max(range(len(dims)), key=lambda k: dims[k])
        if dims[j] <= 1:
            break  # all-1 blocks; nothing fits this memory
        dims[j] //= 2
        plan = BlockPlan(dims[0], tuple(dims[1:-1]), dims[-1], x_has_rank)
    return plan


# ---------------------------------------------------------------------------
# Fused-sweep planning (the arXiv:1708.08976 mode-reuse schedule)
# ---------------------------------------------------------------------------

def batched_choose_blocks(
    batch: int,
    shape: Sequence[int],
    rank: int,
    itemsize: int,
    *,
    memory: Memory | None = None,
    x_has_rank: bool = False,
) -> BlockPlan:
    """The block plan a batched dispatch of ``batch`` element problems runs
    under: the element's plan, :func:`choose_blocks` of ``shape``, for any
    ``batch >= 1`` (raises ``ValueError`` below). The batch is a grid
    dimension of the kernels, so no block spans two elements and the
    working set is the element's. Counterpart of
    ``repro.engine.batch.batched_choose_blocks``. (The Hopper kernels' own
    plans keep the element's blocks too; their split counts alone see the
    batch: :func:`mttkrp_kernel_grid`, :func:`multi_ttm_kernel_grid`,
    :func:`choose_partial_kernel_blocks`.)"""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    return choose_blocks(shape, rank, itemsize, memory=memory, x_has_rank=x_has_rank)


def fused_pair_working_set_words(plan: BlockPlan) -> int:
    """Eq-9 analogue for the fused (B^(0), P) pair kernel: the per-mode
    working set plus the rank-augmented partial tile
    ``bi * prod(bc[:-1]) * br`` of the second output."""
    return fused_pair_kernel_block_words(plan) + plan.weight_scratch_words()


def fused_pair_kernel_block_words(plan: BlockPlan) -> int:
    """X tile + factor tiles + B^(0) tile + P tile (the operand share of
    :func:`fused_pair_working_set_words`, without the KRP weight block)."""
    prod_c = math.prod(plan.block_contract)
    x_tile = plan.block_i * prod_c
    f_tiles = sum(c * plan.block_r for c in plan.block_contract)
    b0_tile = plan.block_i * plan.block_r
    p_tile = plan.block_i * math.prod(plan.block_contract[:-1]) * plan.block_r
    return x_tile + f_tiles + b0_tile + p_tile


def choose_sweep_blocks(
    shape: Sequence[int],
    rank: int,
    itemsize: int = 4,
    vmem_budget: int = VMEM_BUDGET,
    *,
    memory: Memory | None = None,
) -> BlockPlan:
    """Block selection for the fused pair kernel (the reference's
    algorithm, unchanged): start from the per-mode plan, then shrink in
    :func:`choose_blocks`' order (rank, output rows, non-minor contraction
    dims, the minor dim, then relaxed alignment) until the fused working
    set :func:`fused_pair_working_set_words` fits too."""
    if memory is None:
        memory = Memory.tpu_vmem(vmem_budget, itemsize)
    lane, sublane = memory.lane, memory.sublane
    n = len(shape)
    plan = choose_blocks(shape, rank, memory=memory)

    def fused_fits(p: BlockPlan) -> bool:
        return fused_pair_working_set_words(p) * memory.itemsize <= memory.budget_bytes

    def floor(extent: int, unit: int) -> int:
        return max(1, extent) if extent <= unit else unit

    fi = floor(shape[0], sublane)
    fr = floor(rank, lane)
    fc = [floor(shape[d], lane if d == n - 1 else sublane) for d in range(1, n)]
    while not fused_fits(plan):
        bi, br = plan.block_i, plan.block_r
        bc = list(plan.block_contract)
        if br > fr:
            br = max(fr, br // 2)
        elif bi > fi:
            bi = max(fi, bi // 2)
        else:
            shrunk = False
            for d in range(len(bc) - 1):
                if bc[d] > fc[d]:
                    bc[d] = max(fc[d], bc[d] // 2)
                    shrunk = True
                    break
            if not shrunk:
                if bc and bc[-1] > fc[-1]:
                    bc[-1] = max(fc[-1], bc[-1] // 2)
                else:
                    break
        plan = BlockPlan(bi, tuple(bc), br)
    while not fused_fits(plan):
        dims = [plan.block_i, *plan.block_contract, plan.block_r]
        j = max(range(len(dims)), key=lambda k: dims[k])
        if dims[j] <= 1:
            break
        dims[j] //= 2
        plan = BlockPlan(dims[0], tuple(dims[1:-1]), dims[-1])
    return plan


def mttkrp_traffic_model(
    shape: Sequence[int], rank: int, plan: BlockPlan, itemsize: int = 4
) -> dict[str, int]:
    """The reference's functional spelling of :meth:`BlockPlan.traffic_model`."""
    return plan.traffic_model(shape, rank, itemsize)


# ---------------------------------------------------------------------------
# Uniform-b planning (the paper's exact Eq 9/10 setting)
# ---------------------------------------------------------------------------

def best_uniform_block(dims: Sequence[int], memory: Memory | int) -> int:
    """Largest uniform b with b^N + N*b <= M (Eq 9). ``memory`` may be a
    word count or a :class:`Memory` (its word budget is used)."""
    mem_words = memory.budget_words if isinstance(memory, Memory) else memory
    return best_block_size(dims, mem_words)


def uniform_block_feasible(n: int, block: int, memory: Memory | int) -> bool:
    """Eq (9)/(20): b^N + N*b <= M, against a Memory or raw word count."""
    mem_words = memory.budget_words if isinstance(memory, Memory) else memory
    return blocked_feasible_b(n, block, mem_words)


def uniform_plan(dims: Sequence[int], rank: int, memory: Memory | int) -> BlockPlan:
    """A :class:`BlockPlan` with the paper's uniform b in every mode;
    ``plan.eq10_words(dims, rank)`` then equals
    ``core.bounds.seq_blocked_cost(dims, rank, b)`` exactly."""
    b = best_uniform_block(dims, memory)
    plan = BlockPlan(b, (b,) * (len(dims) - 1), rank)
    if int(plan.eq10_words(dims, rank)) != int(seq_blocked_cost(dims, rank, b)):
        raise AssertionError("uniform plan disagrees with Eq (10)")
    return plan


# ---------------------------------------------------------------------------
# Multi-TTM planning (the Tucker/HOSVD kernel, arXiv:2207.10437)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MultiTTMPlan:
    """Block sizes for one canonical Multi-TTM contraction: kept mode first
    (``block_i`` rows), contracted tensor modes next (``block_contract``),
    each contracted mode paired with its small Tucker rank ``ranks[d]``.

    There is no rank tile: the R_d are the small dimensions of the problem,
    so every tile keeps them whole. The reference's TPU kernel builds the
    Kronecker weight block ``W[(c_1..c_k), (r_1..r_k)] = prod_d A_d(c_d,
    r_d)`` in fast memory, and the working set below counts it; the Hopper
    kernel contracts mode by mode instead and never forms it (it has its
    own plan, :class:`MultiTTMKernelPlan`).
    """

    block_i: int
    block_contract: tuple[int, ...]
    ranks: tuple[int, ...]

    # -- Eq 9 analog: working set -----------------------------------------
    def kernel_block_words(self) -> int:
        """Words of the operand tiles alone: tensor tile + matrix tiles +
        output tile."""
        prod_c = math.prod(self.block_contract)
        prod_r = math.prod(self.ranks)
        x_tile = self.block_i * prod_c
        m_tiles = sum(c * r for c, r in zip(self.block_contract, self.ranks))
        out = self.block_i * prod_r
        return x_tile + m_tiles + out

    def weight_scratch_words(self) -> int:
        """Words of the Kronecker weight block ``prod(bc) * prod(R_d)``."""
        return math.prod(self.block_contract) * math.prod(self.ranks)

    def working_set_words(self) -> int:
        """Fast-memory words per grid step: tensor tile + matrix tiles +
        Kronecker weight block + output tile (the Multi-TTM Eq-9 analog;
        uniform-b form in ``core.bounds.multi_ttm_blocked_feasible_b``)."""
        return self.kernel_block_words() + self.weight_scratch_words()

    def fits(self, memory: Memory) -> bool:
        return self.working_set_words() * memory.itemsize <= memory.budget_bytes

    # -- shapes ------------------------------------------------------------
    def blocks_per_mode(self) -> tuple[int, ...]:
        return (self.block_i,) + tuple(self.block_contract)

    def padded_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        blocks = self.blocks_per_mode()
        return tuple(_round_up(s, b) for s, b in zip(shape, blocks))

    def grid(self, shape: Sequence[int]) -> tuple[int, ...]:
        """Tile grid (i, c_1..c_k) of the padded problem (no rank axis: the
        R_d stay whole per tile)."""
        padded = self.padded_shape(shape)
        return (padded[0] // self.block_i,) + tuple(
            padded[1 + d] // self.block_contract[d]
            for d in range(len(self.block_contract))
        )

    # -- Eq 10 analog: traffic --------------------------------------------
    def model_words(self, shape: Sequence[int]) -> int:
        """The blocked Multi-TTM cost generalized to per-mode block sizes:
        one pass over the tensor plus, per block, the matrix subblocks
        (sum_d b_d R_d) and one load+store of the output subblock
        (2 b_i prod R_d). With a uniform b this equals
        ``core.bounds.multi_ttm_blocked_cost`` exactly."""
        blocks = self.blocks_per_mode()
        nblocks = math.prod(math.ceil(s / b) for s, b in zip(shape, blocks))
        per_block = sum(
            b * r for b, r in zip(self.block_contract, self.ranks)
        ) + 2 * self.block_i * math.prod(self.ranks)
        return math.prod(shape) + nblocks * per_block

    def traffic_model(self, shape: Sequence[int], itemsize: int = 4) -> dict[str, int]:
        """Modeled slow<->fast memory traffic (bytes) of the reference's
        tile schedule: grid (i, c_1..c_k), c innermost; the tensor is
        streamed once; matrix d is re-fetched when c_d changes; the output
        tile is written once per i block. ``model_bytes`` is the
        paper-ideal cost for the same per-mode blocks (:meth:`model_words`)."""
        n = len(shape)
        padded = self.padded_shape(shape)
        gi = padded[0] // self.block_i
        gc = [padded[1 + d] // self.block_contract[d] for d in range(n - 1)]
        steps = gi * math.prod(gc)
        x_bytes = steps * self.block_i * math.prod(self.block_contract) * itemsize
        m_bytes = 0
        run = gi
        for d in range(n - 1):
            run *= gc[d]
            m_bytes += run * self.block_contract[d] * self.ranks[d] * itemsize
        o_bytes = gi * self.block_i * math.prod(self.ranks) * itemsize
        total = x_bytes + m_bytes + o_bytes
        return {
            "x_bytes": x_bytes,
            "matrix_bytes": m_bytes,
            "out_bytes": o_bytes,
            "total_bytes": total,
            "model_bytes": self.model_words(shape) * itemsize,
            "steps": steps,
            "working_set_bytes": self.working_set_words() * itemsize,
        }


def choose_multi_ttm_blocks(
    shape: Sequence[int],
    ranks: Sequence[int],
    itemsize: int = 4,
    *,
    memory: Memory | None = None,
) -> MultiTTMPlan:
    """Blocks for a canonical Multi-TTM (kept mode first) against a memory
    budget (the reference's algorithm, unchanged: under
    ``Memory.tpu_vmem()`` and ``Memory.abstract(M)`` it returns exactly the
    reference's plans). The Tucker ranks are never tiled; the kept-mode
    and contraction blocks follow :func:`choose_blocks`' alignment-then-
    shrink strategy. It budgets for the full Kronecker weight, which the
    Hopper kernel never holds, so under ``Memory.h100_smem()`` its tiles
    are tiny; the kernel wrapper plans with
    :func:`choose_multi_ttm_kernel_blocks` instead."""
    if memory is None:
        memory = Memory.tpu_vmem(itemsize=itemsize)
    lane, sublane = memory.lane, memory.sublane
    n = len(shape)
    ranks = tuple(int(r) for r in ranks)

    def start(extent: int, unit: int, pref: int) -> int:
        if extent <= unit:
            return max(1, extent)
        return min(_round_up(extent, unit), pref)

    def floor(extent: int, unit: int) -> int:
        return max(1, extent) if extent <= unit else unit

    bi = start(shape[0], sublane, 128)
    bc: list[int] = []
    for d in range(1, n):
        if d == n - 1:
            bc.append(start(shape[d], lane, 128))
        else:
            bc.append(start(shape[d], sublane, max(sublane, 8)))
    fi = floor(shape[0], sublane)
    fc = [floor(shape[d], lane if d == n - 1 else sublane) for d in range(1, n)]
    plan = MultiTTMPlan(bi, tuple(bc), ranks)
    while not plan.fits(memory):
        bi = plan.block_i
        bc = list(plan.block_contract)
        if bi > fi:
            bi = max(fi, bi // 2)
        else:
            shrunk = False
            for d in range(len(bc) - 1):
                if bc[d] > fc[d]:
                    bc[d] = max(fc[d], bc[d] // 2)
                    shrunk = True
                    break
            if not shrunk:
                if bc and bc[-1] > fc[-1]:
                    bc[-1] = max(fc[-1], bc[-1] // 2)
                else:
                    break
        plan = MultiTTMPlan(bi, tuple(bc), ranks)
    while not plan.fits(memory):
        dims = [plan.block_i, *plan.block_contract]
        j = max(range(len(dims)), key=lambda k: dims[k])
        if dims[j] <= 1:
            break  # all-1 blocks: the ranks alone exceed this memory
        dims[j] //= 2
        plan = MultiTTMPlan(dims[0], tuple(dims[1:]), ranks)
    return plan


def uniform_multi_ttm_plan(
    dims: Sequence[int], ranks: Sequence[int], memory: Memory | int
) -> MultiTTMPlan:
    """A :class:`MultiTTMPlan` with the paper's uniform b in every tensor
    mode; ``plan.model_words(dims)`` then equals
    ``core.bounds.multi_ttm_blocked_cost(dims, ranks, b)`` exactly."""
    mem_words = memory.budget_words if isinstance(memory, Memory) else memory
    b = multi_ttm_best_block_size(dims, ranks, mem_words)
    plan = MultiTTMPlan(b, (b,) * (len(dims) - 1), tuple(int(r) for r in ranks))
    if int(plan.model_words(dims)) != int(multi_ttm_blocked_cost(dims, ranks, b)):
        raise AssertionError("uniform Multi-TTM plan disagrees with the blocked cost")
    return plan


#: CTAs the split rules want in flight on each SM, and the H100's SM count.
CTAS_PER_SM = 2
H100_SMS = 132
#: The Hopper MTTKRP kernel's tiles (``csrc/mttkrp.cu``): rows a CTA (4 warps
#: of 16 MT rows) and rank columns a CTA (2 warps of 8 NT columns).
MTTKRP_BLOCK_I = (64, 128)
MTTKRP_BLOCK_R = (16, 32, 64, 128)
#: Bytes of each X row a chunk of ``block_k`` flat contraction indices spans.
MTTKRP_CHUNK_BYTES = (32, 64, 128, 256)
#: The Multi-TTM kernel's tile rows (``csrc/multi_ttm.cu``): 192 takes a
#: C_{k-1} of up to 192 (180 at 180^4) in one tile.
MULTI_TTM_BLOCK_M = (64, 128, 192)


@dataclass(frozen=True)
class MTTKRPKernelPlan:
    """The Hopper MTTKRP kernel's plan for a canonical ``(I, C_1..C_k)``
    problem, seen as an ``(I, K)`` matrix, K = prod C_d: ``block_i`` rows and
    ``block_r`` rank columns a CTA, chunks of ``block_k`` flat contraction
    indices (32, 64, 128 or 256 bytes of each row), and a ring of ``stages``
    (2 to 4) chunk buffers in shared memory."""

    block_i: int
    block_k: int
    block_r: int
    stages: int

    def check(self, itemsize: int) -> None:
        """Raise ``ValueError`` unless the kernel takes these blocks."""
        _check_ring_blocks(self, self.block_i, itemsize, "the MTTKRP kernel takes block_i")


def _check_ring_blocks(plan, rows: int, itemsize: int, what: str,
                       row_blocks: Sequence[int] = MTTKRP_BLOCK_I) -> None:
    """Raise ``ValueError`` unless ``csrc/ring.cuh`` takes the blocks: rows
    in ``row_blocks``, ``block_r`` in ``MTTKRP_BLOCK_R``, chunks of
    ``MTTKRP_CHUNK_BYTES`` bytes, 2 to 4 stages."""
    if (rows not in row_blocks or plan.block_r not in MTTKRP_BLOCK_R
            or plan.block_k * itemsize not in MTTKRP_CHUNK_BYTES or not 2 <= plan.stages <= 4):
        raise ValueError(
            f"{plan}: {what} in {tuple(row_blocks)}, block_r in {MTTKRP_BLOCK_R}, block_k of "
            f"{MTTKRP_CHUNK_BYTES} bytes, 2 to 4 stages"
        )


def mttkrp_kernel_smem_bytes(plan: MTTKRPKernelPlan, itemsize: int, ncontract: int = 2) -> int:
    """Dynamic shared memory of the Hopper MTTKRP kernel under ``plan`` with
    ``ncontract`` contraction axes (``csrc/mttkrp.cu:make_tile_layout``,
    mirrored here so a plan can be chosen on a host without the built
    library; the card tests hold the two equal): ``stages`` chunk buffers,
    each ``block_i`` rows of ``block_k`` X elements (16 bytes of skew a
    row), ``block_k`` rows of the last factor (``block_r`` elements and 32
    bytes of skew in fp32, 16 in bf16) and one ``block_r`` row of each of the
    ``ncontract - 1`` leading factors."""
    plan.check(itemsize)
    row_bytes = plan.block_k * itemsize + 16
    frow_bytes = plan.block_r * itemsize + (32 if itemsize == 4 else 16)
    stage = (plan.block_i * row_bytes + plan.block_k * frow_bytes
             + (ncontract - 1) * plan.block_r * itemsize)
    return plan.stages * stage


def n_splits(ctas: int, outer_tiles: int, sms: int) -> int:
    """Splits of a contraction over CTAs: enough that
    ``ctas * S >= CTAS_PER_SM * sms``, never more than its tiles."""
    return max(1, min(outer_tiles, math.ceil(CTAS_PER_SM * sms / max(ctas, 1))))


def mttkrp_kernel_grid(shape: Sequence[int], rank: int, plan: MTTKRPKernelPlan,
                       sms: int = H100_SMS, batch: int = 1) -> tuple[int, int, int]:
    """(row tiles, rank tiles, splits) of the kernel's launch for one problem
    of ``shape``, ``batch`` of them in the launch (the grid's z dimension).
    K is walked in chunks of ``block_k`` last-axis indices under one leading
    index tuple each; enough splits of the chunks that ``CTAS_PER_SM`` CTAs
    per SM are in flight over the whole batch, never more than there are
    chunks: a batch that fills the card alone runs unsplit."""
    rows = math.ceil(shape[0] / plan.block_i)
    rtiles = math.ceil(rank / plan.block_r)
    chunks = math.prod(shape[1:-1]) * math.ceil(shape[-1] / plan.block_k)
    return rows, rtiles, n_splits(rows * rtiles * batch, chunks, sms)


def _choose_ring_plan(rows: int, c_last: int, rank: int, itemsize: int, smem, cls, what: str,
                      row_blocks: Sequence[int] = ()):
    """The ring kernels' default plan (``csrc/ring.cuh``), against their real
    shared memory ``smem(plan)``: ``block_r`` is ``rank`` rounded up to a
    power of two from 16 to 128, so the matrix is read once for ranks up to
    128; the row block is 128 (64 for ``rows <= 64``), or, given
    ``row_blocks``, the one of them that pads ``rows`` least (the larger on a
    tie); a chunk spans 256 bytes of the last axis, or the fewest bytes in
    ``MTTKRP_CHUNK_BYTES`` that hold a shorter one. The ring takes as many of
    4, 3, 2 stages as fit ``SMEM_BUDGET`` (two CTAs per SM); failing that,
    the chunk narrows, then the rows, then the plan is made against one
    CTA's limit."""
    if row_blocks:
        blocks = sorted(row_blocks, key=lambda b: (math.ceil(rows / b) * b, -b))
        blocks = blocks[:1] + sorted((b for b in blocks[1:] if b < blocks[0]), reverse=True)
    else:
        blocks = sorted({128 if rows > 64 else 64, 64}, reverse=True)
    br = min(128, max(16, 1 << (max(rank, 1) - 1).bit_length()))
    kb = next(b for b in MTTKRP_CHUNK_BYTES if b >= min(256, c_last * itemsize))
    for budget in (SMEM_BUDGET, SMEM_PER_CTA_MAX):
        for block in blocks:
            for width in [b for b in reversed(MTTKRP_CHUNK_BYTES) if b <= kb]:
                for stages in (4, 3, 2):
                    plan = cls(block, width // itemsize, br, stages)
                    if smem(plan) <= budget:
                        return plan
    raise ValueError(f"{what} fits {SMEM_PER_CTA_MAX} bytes of shared memory")


def choose_mttkrp_kernel_blocks(shape: Sequence[int], rank: int,
                                itemsize: int = 4) -> MTTKRPKernelPlan:
    """The Hopper MTTKRP kernel's default plan for a canonical
    ``(I, C_1..C_k)`` problem (:func:`_choose_ring_plan` against
    :func:`mttkrp_kernel_smem_bytes`, rows along I). (On the H100, wide
    chunks and two CTAs an SM beat deeper rings: ``scripts/probe_mttkrp.py``,
    PERF.md.)"""
    return _choose_ring_plan(
        int(shape[0]), int(shape[-1]), rank, itemsize,
        lambda p: mttkrp_kernel_smem_bytes(p, itemsize, len(shape) - 1), MTTKRPKernelPlan,
        f"MTTKRP kernel: no plan for shape {tuple(shape)}, rank {rank}")


# ---------------------------------------------------------------------------
# The fused (B0, P) pair kernel (csrc/sweep.cu): the MTTKRP kernel's plan
# ---------------------------------------------------------------------------

def pair_kernel_smem_bytes(plan: MTTKRPKernelPlan, itemsize: int, ncontract: int) -> int:
    """Dynamic shared memory of the Hopper pair kernel under ``plan`` with
    ``ncontract`` contraction axes (``csrc/sweep.cu:pair_smem_bytes``): the
    MTTKRP kernel's ring (:func:`mttkrp_kernel_smem_bytes`) and the B0
    accumulators, one fp32 word per output element of the tile."""
    return mttkrp_kernel_smem_bytes(plan, itemsize, ncontract) + 4 * plan.block_i * plan.block_r


def pair_kernel_grid(shape: Sequence[int], rank: int, plan: MTTKRPKernelPlan,
                     sms: int = H100_SMS) -> tuple[int, int, int]:
    """(row tiles, rank tiles, splits) of the pair kernel's launch: the
    leading index tuples ``prod(C[:-1])`` are split over CTAs, whole tuples
    only, enough that ``CTAS_PER_SM`` CTAs per SM are in flight."""
    rows = math.ceil(shape[0] / plan.block_i)
    rtiles = math.ceil(rank / plan.block_r)
    return rows, rtiles, n_splits(rows * rtiles, math.prod(shape[1:-1]), sms)


def choose_pair_kernel_blocks(shape: Sequence[int], rank: int,
                              itemsize: int = 4) -> MTTKRPKernelPlan:
    """The pair kernel's default plan for a canonical ``(I, C_1..C_{N-1})``
    problem (:func:`_choose_ring_plan` against
    :func:`pair_kernel_smem_bytes`)."""
    return _choose_ring_plan(
        int(shape[0]), int(shape[-1]), rank, itemsize,
        lambda p: pair_kernel_smem_bytes(p, itemsize, len(shape) - 1), MTTKRPKernelPlan,
        f"fused pair kernel: no plan for shape {tuple(shape)}, rank {rank}")


# ---------------------------------------------------------------------------
# The kept-mode Multi-TTM kernel (csrc/multi_ttm.cu)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MultiTTMKernelPlan:
    """The Hopper Multi-TTM kernel's plan for a kept-mode-first
    ``(I, C_1..C_k)`` problem, X seen as the matrix of rows
    ``(i, c_1..c_{k-1})`` by ``C_k``: ``block_m`` rows a tile (consecutive
    ``c_{k-1}`` under one ``(i, c_1..c_{k-2})``; consecutive i when k = 1),
    chunks of ``block_k`` ``C_k`` indices (32 to 256 bytes of each row),
    ``block_r`` columns of ``R_k`` a CTA, and a ring of ``stages`` chunk
    buffers. The kernel takes the MTTKRP kernel's block sizes."""

    block_m: int
    block_k: int
    block_r: int
    stages: int

    def check(self, itemsize: int) -> None:
        """Raise ``ValueError`` unless the kernel takes these blocks."""
        _check_ring_blocks(self, self.block_m, itemsize, "the Multi-TTM kernel takes block_m",
                           MULTI_TTM_BLOCK_M)


def multi_ttm_kernel_smem_bytes(plan: MultiTTMKernelPlan, itemsize: int,
                                ranks: Sequence[int]) -> int:
    """Dynamic shared memory of the Hopper Multi-TTM kernel under ``plan``
    for ranks ``R_1..R_k`` (``csrc/multi_ttm.cu:make_ttm_layout``, mirrored
    here so a plan can be chosen on a host without the built library; the
    card tests hold the two equal): the ring (the MTTKRP kernel's, with no
    rows beside ``A_k``'s) and, for k >= 2, fp32: the tile's T
    (``block_m x (block_r + 4)``), ``A_{k-1}``'s rows of the tile
    (``block_m x R4``, R4 = ``R_{k-1}`` rounded up to 4), the outer weights
    (``prod R[:-2]``, rounded up to 4), the fold's ``V`` (``R4 x block_r``)
    and the output tile ``prod R[:-1] x min(block_r, R_k)``. Never the
    Kronecker weight."""
    plan.check(itemsize)
    skew = 32 if itemsize == 4 else 16
    ring = plan.stages * (plan.block_m * (plan.block_k * itemsize + 16)
                          + plan.block_k * (plan.block_r * itemsize + skew))
    if len(ranks) < 2:
        return ring
    n_w, rp = math.prod(ranks[:-2]), ranks[-2]
    return ring + 4 * (plan.block_m * (plan.block_r + 4) + plan.block_m * _round_up(rp, 4)
                       + _round_up(n_w, 4) + _round_up(rp, 4) * plan.block_r
                       + n_w * rp * min(plan.block_r, ranks[-1]))


def multi_ttm_kernel_grid(shape: Sequence[int], ranks: Sequence[int], plan: MultiTTMKernelPlan,
                          sms: int = H100_SMS, batch: int = 1) -> tuple[int, int, int]:
    """(units, rank tiles, splits) of the Multi-TTM kernel's launch for one
    problem of ``shape``, ``batch`` of them in the launch (the grid's z
    dimension). A unit is one i (k >= 2), whose tiles ``prod(C[1:-2]) *
    ceil(C_{k-1} / block_m)`` are split over enough CTAs that
    ``CTAS_PER_SM`` CTAs per SM are in flight over the whole batch; with
    k = 1 a unit is a tile of ``block_m`` rows, never split."""
    rtiles = math.ceil(ranks[-1] / plan.block_r)
    if len(shape) == 2:
        return math.ceil(shape[0] / plan.block_m), rtiles, 1
    tiles = math.prod(shape[1:-2]) * math.ceil(shape[-2] / plan.block_m)
    return shape[0], rtiles, n_splits(shape[0] * rtiles * batch, tiles, sms)


def choose_multi_ttm_kernel_blocks(shape: Sequence[int], ranks: Sequence[int],
                                   itemsize: int = 4) -> MultiTTMKernelPlan:
    """The Multi-TTM kernel's default plan for a kept-mode-first
    ``(I, C_1..C_k)`` problem (:func:`_choose_ring_plan` against
    :func:`multi_ttm_kernel_smem_bytes`, rows along ``C_{k-1}``, or I for
    k = 1, in the block of ``MULTI_TTM_BLOCK_M`` that pads them least: each
    tile costs a fold). Raises where nothing fits one CTA: the output tile
    ``prod R[:-1] x min(128, R_k)`` alone is then too large."""
    ranks = tuple(int(r) for r in ranks)
    rows = shape[-2] if len(shape) > 2 else shape[0]
    return _choose_ring_plan(
        int(rows), int(shape[-1]), ranks[-1], itemsize,
        lambda p: multi_ttm_kernel_smem_bytes(p, itemsize, ranks), MultiTTMKernelPlan,
        f"Multi-TTM kernel: no plan for shape {tuple(shape)}, ranks {ranks}",
        MULTI_TTM_BLOCK_M)


# ---------------------------------------------------------------------------
# The rank-augmented partial contraction (csrc/sweep.cu): a streaming kernel
# ---------------------------------------------------------------------------

#: The partial kernel's CTA: 256 threads in 8 warps (``csrc/common.cuh``).
PARTIAL_THREADS = 256
PARTIAL_WARPS = PARTIAL_THREADS // 32
#: The axis the warp spans beside the r-vectors: ``"rows"``, the innermost
#: kept axis (each output sum stays in one thread), or ``"contract"``, the
#: innermost contraction axis (each thread's sums folded across the lane
#: axis's threads in a fixed order).
PARTIAL_LAYOUTS = ("rows", "contract")
#: Rows a thread owns, and the node loads a thread may keep in flight
#: (rows x unrolled c steps); the kernel is instantiated for each row count.
PARTIAL_THREAD_ROWS = (1, 2, 4, 8)
PARTIAL_LOADS = (1, 2, 4, 8)
#: The widest load: 16 bytes along r.
PARTIAL_VEC_BYTES = 16
#: Nodes up to this size are planned without a split-K reduction where the
#: card allows (:func:`choose_partial_kernel_blocks`): 8 MiB is what the
#: card reads in about 3 microseconds, the cost of the reduction's launch.
PARTIAL_SMALL_NODE_BYTES = 8 << 20


@dataclass(frozen=True)
class PartialKernelPlan:
    """The Hopper partial kernel's plan for a node ``N (K.., C_1..C_k, R)``
    read in place, rank axis at unit stride: ``layout`` (the axis the warp
    spans beside the r-vectors, :data:`PARTIAL_LAYOUTS`), ``block_rows``
    kept rows a CTA, ``vec`` elements a load along r (16 bytes' worth, or
    1), ``loads`` node loads a thread keeps in flight (its rows times the c
    steps it unrolls), and ``splits`` CTAs the contraction is split over
    (each writes its own fp32 slab)."""

    layout: str
    block_rows: int
    vec: int
    loads: int
    splits: int

    def threads(self, rank: int) -> tuple[int, int, int]:
        """(threads along r, threads along the lane axis, rank tiles):
        ``ceil(R / vec)`` r-vectors, at most 32 threads across them (a
        power of two), the rest of the CTA along the lane axis."""
        return partial_kernel_threads(rank, self.vec)

    def rows_per_thread(self, rank: int) -> int:
        """Rows a thread owns: ``block_rows`` spread over the lane threads
        (``"rows"``), or all of them (``"contract"``)."""
        if self.layout == "rows":
            return self.block_rows // self.threads(rank)[1]
        return self.block_rows

    def check(self, rank: int, itemsize: int) -> None:
        """Raise ``ValueError`` unless the kernel takes this plan."""
        ok = (self.layout in PARTIAL_LAYOUTS and self.vec in (1, PARTIAL_VEC_BYTES // itemsize)
              and rank % self.vec == 0 and self.loads in PARTIAL_LOADS
              and 1 <= self.splits <= 65535)
        if ok:
            rows = self.rows_per_thread(rank)
            ok = (rows in PARTIAL_THREAD_ROWS and self.loads >= rows
                  and (self.layout == "contract" or self.block_rows == rows * self.threads(rank)[1]))
        if not ok:
            raise ValueError(
                f"{self}: layout in {PARTIAL_LAYOUTS}, vec 1 or {PARTIAL_VEC_BYTES} bytes' "
                f"worth dividing R={rank}, {PARTIAL_THREAD_ROWS} rows a thread, loads in "
                f"{PARTIAL_LOADS} and at least the rows, 1 to 65535 splits")


def partial_kernel_threads(rank: int, vec: int) -> tuple[int, int, int]:
    """(threads along r, threads along the lane axis, rank tiles) of the
    partial kernel for rank ``rank`` in loads of ``vec`` elements."""
    nvec = -(-rank // vec)
    tr = min(32, 1 << (nvec - 1).bit_length())
    return tr, PARTIAL_THREADS // tr, -(-nvec // tr)


def partial_kernel_smem_bytes(plan: PartialKernelPlan, rank: int) -> int:
    """Dynamic shared memory of the partial kernel under ``plan``
    (``csrc/sweep.cu:partial_smem_bytes``, mirrored here; the card tests
    hold the two equal): none for ``"rows"``; for ``"contract"`` the
    cross-warp fold, one fp32 word per warp, row and column of the CTA
    (``block_rows x threads along r x vec``)."""
    if plan.layout == "rows":
        return 0
    tr = plan.threads(rank)[0]
    return 4 * PARTIAL_WARPS * plan.block_rows * tr * plan.vec


def partial_kernel_grid(shape: Sequence[int], rank: int, plan: PartialKernelPlan,
                        nkeep: int = 1) -> tuple[int, int, int]:
    """(row blocks, rank tiles, units) of the partial kernel's launch for a
    node of axis sizes ``shape`` (rank axis excluded; ``nkeep`` kept axes
    first, then the contraction axes). A unit is one outer contraction
    tuple ``(c_1..c_{k-1})`` with a chunk of the innermost axis ``C_k``: as
    many indices as the CTA's lane threads take in their unrolled steps
    (``"contract"``), or a thread's unrolled steps (``"rows"``). The
    ``plan.splits`` splits take consecutive runs of units."""
    rows = math.prod(shape[:nkeep])
    tl, rtiles = plan.threads(rank)[1:]
    unroll = plan.loads // plan.rows_per_thread(rank)
    chunk = unroll * (tl if plan.layout == "contract" else 1)
    units = math.prod(shape[nkeep:-1]) * -(-shape[-1] // chunk)
    return -(-rows // plan.block_rows), rtiles, units


def one_wave_splits(ctas: int, units: int, sms: int) -> int:
    """Splits of the partial kernel's contraction over ``ctas`` CTAs: as
    many as keep the launch within one wave of ``CTAS_PER_SM`` CTAs per SM,
    at least one, never more than its ``units``. (:func:`n_splits` fills
    the wave at least, and so may start a second one that is nearly empty.)"""
    return max(1, min(units, CTAS_PER_SM * sms // max(ctas, 1), 65535))


@functools.lru_cache(maxsize=4096)
def choose_partial_kernel_blocks(shape: Sequence[int], strides: Sequence[int], rank: int,
                                 itemsize: int = 4, sms: int = H100_SMS, *, nkeep: int = 1,
                                 aligned: bool = True, batch: int = 1) -> PartialKernelPlan:
    """The partial kernel's default plan for a node read in place: axis
    sizes ``shape`` and element strides ``strides`` (rank axis excluded, at
    unit stride; ``nkeep`` kept axes first, then the contraction axes,
    innermost last). Cached per argument tuple, so a node's plan costs the
    host one lookup after its first call.

    * ``vec``: 16 bytes along r where R, every stride and (``aligned``) the
      pointers allow it, else one element.
    * ``loads``: 8 in flight a thread.
    * A node of more than :data:`PARTIAL_SMALL_NODE_BYTES`: ``layout``
      spans the axis that lies next to r in memory (``"rows"`` when the
      innermost kept axis has a smaller stride than every contraction axis
      and there is more than one row, ``"contract"`` otherwise); rows a
      thread of 1, 2, 4, 8 (at most 32 accumulators), the one that
      minimises the padded rows times ``1 + 1 / (2 rows)`` (a factor load,
      served by L1 or L2, costs about half a node load; one serves a
      thread's rows), fewer padded rows on a tie; and
      :func:`one_wave_splits` (a second, nearly empty wave cost 20 % at
      180^4: ``scripts/probe_partial.py``).
    * A smaller node, which the card reads in a few microseconds, about
      what a split-K reduction's launch costs: ``"contract"``, the most
      rows a thread whose row blocks alone give every SM a CTA (else one),
      and no split unless the row blocks are fewer than the SMs.

    ``batch`` nodes of this view in one launch (the grid's z dimension)
    change the split count alone: it is chosen for ``batch`` times the
    element's CTAs, so a batch that fills the card runs unsplit. The
    layout, rows, vector and loads are the element's.
    """
    shape, strides = tuple(int(s) for s in shape), tuple(int(s) for s in strides)
    wide = PARTIAL_VEC_BYTES // itemsize
    vec = wide if aligned and rank % wide == 0 and all(s % wide == 0 for s in strides) else 1
    i_rows = math.prod(shape[:nkeep])
    small = math.prod(shape) * rank * itemsize <= PARTIAL_SMALL_NODE_BYTES
    kept, contract = strides[nkeep - 1], min(strides[nkeep:])
    layout = "rows" if not small and i_rows > 1 and kept < contract else "contract"
    tl, rtiles = partial_kernel_threads(rank, vec)[1:]
    loads = max(PARTIAL_LOADS)
    candidates = [r for r in PARTIAL_THREAD_ROWS if r * vec <= 32]

    def block(rows: int) -> int:
        return rows * (tl if layout == "rows" else 1)

    def grid(rows: int) -> tuple[int, int, int]:
        return partial_kernel_grid(shape, rank, PartialKernelPlan(layout, block(rows), vec,
                                                                  loads, 1), nkeep)

    if small:
        rows = max((r for r in candidates if grid(r)[0] * rtiles >= sms), default=1)
        ctas, units = grid(rows)[0] * rtiles * batch, grid(rows)[2]
        splits = 1 if ctas >= sms else min(units, -(-sms // ctas))
    else:
        def cost(rows: int) -> tuple[float, int]:
            padded = -(-i_rows // block(rows)) * block(rows)
            return padded * (1 + 1 / (2 * rows)), padded

        rows = min(candidates, key=cost)
        splits = one_wave_splits(grid(rows)[0] * rtiles * batch, grid(rows)[2], sms)
    return PartialKernelPlan(layout, block(rows), vec, loads, min(65535, splits))


# ---------------------------------------------------------------------------
# The Mamba2 intra-chunk SSD term (csrc/ssd_intra.cu): its launch grid
# ---------------------------------------------------------------------------

def ssd_intra_kernel_grid(bcn: int, q: int, h: int, tile: int,
                          heads: int) -> tuple[int, int, int]:
    """(CTAs, 1, 1) of the SSD kernel's 1-D launch for ``bcn`` chunks of ``q``
    rows and ``h`` heads under a plan of ``tile`` rows and ``heads`` heads a
    CTA (``csrc/ssd_intra.cu:ssd_grid``): one CTA a (row tile, chunk, head
    block). ``blockIdx.x`` takes the head block fastest, then the chunk,
    then the row tile, from the last one (the longest CTAs first)."""
    if h % heads:
        raise ValueError(f"ssd_intra: {heads} heads a CTA do not divide H={h}")
    return bcn * (h // heads) * -(-q // tile), 1, 1
