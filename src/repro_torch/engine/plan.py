"""The planner: one source of truth for MTTKRP blocking and traffic models.

Counterpart of ``repro.engine.plan`` (the MTTKRP and fused-sweep parts;
the Multi-TTM planner comes with its slice):

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
    returns exactly the reference's plans.
  * :func:`choose_sweep_blocks` (with :func:`fused_pair_working_set_words`)
    — the fused (B0, P) pair's plan, unchanged from the reference.
  * :func:`best_uniform_block` / :func:`uniform_block_feasible` /
    :func:`uniform_plan` — the paper's exact uniform-b selection (Eq 9).

Formula provenance stays in :mod:`repro_torch.core.bounds`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

from ..core.bounds import best_block_size, blocked_feasible_b, seq_blocked_cost

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
