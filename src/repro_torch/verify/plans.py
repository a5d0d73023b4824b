"""Static plan verification: pure arithmetic over plan objects, no arrays.
Counterpart of ``repro.verify.plans``, extended to the Hopper kernels' plans.

Every check here is a statement about a *plan*, not about an execution, so
it is proven by evaluating the plan's own methods against a
:class:`~repro_torch.engine.plan.Memory` descriptor. The reference's
checks, with its rule codes and subject strings:

* **Eq 9 (working set)** — ``plan.working_set_words() * itemsize`` must fit
  ``memory.budget_bytes``. A plan is only *charged* as infeasible when a
  feasible plan exists at all (the all-ones plan fits).
* **Decomposition** — ``working_set_words == kernel_block_words +
  weight_scratch_words``.
* **Padding/divisibility** — ``padded_shape`` must be the minimal
  block-multiple cover of the shape, and ``grid`` must tile it exactly.
* **Eq 10 vs Thm 4.1** — a feasible plan's modeled traffic can never
  undercut the sequential memory-dependent lower bound.
* **Itemsize propagation** — ``Memory.with_itemsize`` re-describes the same
  physical bytes.
* **Batching** — the batched planner's plan is the element's.

:func:`verify_plans` sweeps the reference's shape x rank x Memory lattice
(the port adds its default memory, ``Memory.h100_smem``, at itemsize 4 and
2) through ``choose_blocks`` / ``choose_sweep_blocks`` /
``choose_multi_ttm_blocks`` / ``best_uniform_block``.

The port's kernels plan themselves against their real shared memory, so
:func:`check_kernel_plans` proves their choosers over a lattice of the
port's cells (:func:`default_kernel_cases`), each rule with its own code:

* ``kernel-plan-refused`` — the plan is one the kernel takes
  (``plan.check``);
* ``kernel-smem-over-cta`` — its shared memory (the Python mirror of the
  kernel's own count) is within one CTA's limit, ``SMEM_PER_CTA_MAX``;
* ``kernel-smem-over-budget`` — and within the planning budget
  ``SMEM_BUDGET`` wherever the kernel's smallest plan fits that budget;
* ``kernel-grid-cover`` — the launch grid covers the output rows and rank
  columns minimally: fewer than one block of slack in each;
* ``kernel-splits`` — the contraction is split between 1 and its number of
  chunks (the units a split takes);
* ``kernel-grid-limit`` — the launch's y (splits) and z (the batch)
  dimensions stay within 65,535, its x within 2^31 - 1.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Sequence

from ..core.bounds import multi_ttm_seq_lb_memory, seq_lb_memory
from ..engine.plan import (
    H100_SMS,
    SMEM_BUDGET,
    SMEM_PER_CTA_MAX,
    BlockPlan,
    Memory,
    MultiTTMPlan,
    best_uniform_block,
    choose_blocks,
    choose_multi_ttm_blocks,
    choose_multi_ttm_kernel_blocks,
    choose_mttkrp_kernel_blocks,
    choose_pair_kernel_blocks,
    choose_partial_kernel_blocks,
    choose_sweep_blocks,
    fused_pair_kernel_block_words,
    fused_pair_working_set_words,
    multi_ttm_kernel_grid,
    multi_ttm_kernel_smem_bytes,
    mttkrp_kernel_grid,
    mttkrp_kernel_smem_bytes,
    pair_kernel_grid,
    pair_kernel_smem_bytes,
    partial_kernel_grid,
    partial_kernel_smem_bytes,
    uniform_block_feasible,
)
from . import Finding

#: The default verification lattice: the reference's shapes (3-/4-way,
#: degenerate sub-alignment extents, MXU-sized problems) and ranks; the
#: memories are the port's default (``Memory.h100_smem``, one CTA's shared
#: memory) and the reference's (TPU VMEM) at two itemsizes each, plus
#: abstract word budgets from starved to ample.
DEFAULT_SHAPES: tuple[tuple[int, ...], ...] = (
    (24, 10, 12),
    (64, 64, 64),
    (128, 32, 8),
    (7, 5, 3),
    (200, 3, 130),
    (16, 8, 6, 4),
)
DEFAULT_RANKS: tuple[int, ...] = (1, 4, 16, 64)
DEFAULT_MEMORIES: tuple[Memory, ...] = (
    Memory.h100_smem(itemsize=4),
    Memory.h100_smem(itemsize=2),
    Memory.tpu_vmem(itemsize=4),
    Memory.tpu_vmem(itemsize=2),
    Memory.abstract(100),
    Memory.abstract(512),
    Memory.abstract(4096),
    Memory.abstract(2 ** 16),
)


def _subject(kind: str, plan: object, shape: Sequence[int], extra: str = "") -> str:
    return f"{kind}[shape={tuple(shape)}{extra}] {plan!r}"


def check_block_plan(
    plan: BlockPlan,
    shape: Sequence[int],
    rank: int,
    memory: Memory,
) -> list[Finding]:
    """All static checks for one :class:`BlockPlan` against one Memory."""
    out: list[Finding] = []
    sub = _subject("BlockPlan", plan, shape, f",rank={rank}")

    blocks = plan.blocks_per_mode()
    if plan.block_r < 1 or any(b < 1 for b in blocks):
        out.append(Finding(
            "plans", "nonpositive-block", sub,
            f"block sizes must be >= 1, got {blocks} / br={plan.block_r}",
        ))
        return out  # everything below divides by the blocks

    # Eq 9: only charge infeasibility when a feasible plan exists at all.
    if not plan.fits(memory):
        minimal = BlockPlan(
            1, (1,) * len(plan.block_contract), 1, plan.x_has_rank
        )
        if minimal.fits(memory):
            out.append(Finding(
                "plans", "eq9-infeasible", sub,
                f"working set {plan.working_set_words()} words exceeds "
                f"budget {memory.budget_words} words while the all-ones "
                f"plan fits (Eq 9 violated by choice, not by necessity)",
            ))

    # working-set decomposition (the kernel analyzer's pin).
    ws = plan.working_set_words()
    parts = plan.kernel_block_words() + plan.weight_scratch_words()
    if ws != parts:
        out.append(Finding(
            "plans", "ws-decomposition", sub,
            f"working_set_words()={ws} != kernel_block_words + "
            f"weight_scratch_words = {parts}",
        ))

    # padding: minimal block-multiple cover.
    padded = plan.padded_shape(shape)
    for d, (s, p, b) in enumerate(zip(shape, padded, blocks)):
        if p % b != 0 or p < s or p - s >= b:
            out.append(Finding(
                "plans", "padding", sub,
                f"mode {d}: padded extent {p} is not the minimal "
                f"multiple of block {b} covering {s}",
            ))

    # grid: exact tiling of the padded problem (plus the rank tile).
    grid = plan.grid(shape, rank)
    r_pad = math.ceil(rank / plan.block_r) * plan.block_r
    want = (r_pad // plan.block_r,) + tuple(
        p // b for p, b in zip(padded, blocks)
    )
    if grid != want or any(g < 1 for g in grid):
        out.append(Finding(
            "plans", "grid", sub,
            f"grid {grid} does not tile padded shape {padded} "
            f"(+rank {rank}->{r_pad}); expected {want}",
        ))

    # Eq 10 >= Thm 4.1 (only meaningful for plans that satisfy Eq 9).
    if plan.fits(memory):
        lb = max(seq_lb_memory(shape, rank, memory.budget_words), 0.0)
        eq10 = plan.eq10_words(shape, rank)
        if eq10 < lb:
            out.append(Finding(
                "plans", "eq10-below-bound", sub,
                f"modeled traffic {eq10} words undercuts the Thm-4.1 "
                f"sequential lower bound {lb:.0f} words at "
                f"M={memory.budget_words}",
            ))
    return out


def check_sweep_plan(
    plan: BlockPlan,
    shape: Sequence[int],
    rank: int,
    memory: Memory,
) -> list[Finding]:
    """Checks for a fused-pair sweep plan: everything a plain plan must
    satisfy, plus the *fused* working set (B^(0) and P tiles resident
    together) fitting the budget, with the same decomposition pin."""
    out = check_block_plan(plan, shape, rank, memory)
    sub = _subject("SweepPlan", plan, shape, f",rank={rank}")
    fused = fused_pair_working_set_words(plan)
    if fused * memory.itemsize > memory.budget_bytes:
        minimal = BlockPlan(1, (1,) * len(plan.block_contract), 1)
        if fused_pair_working_set_words(minimal) * memory.itemsize \
                <= memory.budget_bytes:
            out.append(Finding(
                "plans", "eq9-infeasible-fused", sub,
                f"fused working set {fused} words exceeds budget "
                f"{memory.budget_words} words while the all-ones plan fits",
            ))
    parts = fused_pair_kernel_block_words(plan) + plan.weight_scratch_words()
    if fused != parts:
        out.append(Finding(
            "plans", "ws-decomposition", sub,
            f"fused_pair_working_set_words={fused} != "
            f"fused_pair_kernel_block_words + weight_scratch_words = {parts}",
        ))
    return out


def check_multi_ttm_plan(
    plan: MultiTTMPlan,
    shape: Sequence[int],
    ranks: Sequence[int],
    memory: Memory,
) -> list[Finding]:
    """All static checks for one :class:`MultiTTMPlan` (the Eq-9/Eq-10
    analogs of arXiv:2207.10437) against one Memory."""
    out: list[Finding] = []
    sub = _subject("MultiTTMPlan", plan, shape, f",ranks={tuple(ranks)}")

    blocks = plan.blocks_per_mode()
    if any(b < 1 for b in blocks) or any(r < 1 for r in plan.ranks):
        out.append(Finding(
            "plans", "nonpositive-block", sub,
            f"block sizes/ranks must be >= 1, got {blocks} / {plan.ranks}",
        ))
        return out

    if not plan.fits(memory):
        minimal = MultiTTMPlan(
            1, (1,) * len(plan.block_contract), plan.ranks
        )
        if minimal.fits(memory):
            out.append(Finding(
                "plans", "eq9-infeasible", sub,
                f"working set {plan.working_set_words()} words exceeds "
                f"budget {memory.budget_words} words while the all-ones "
                f"plan fits",
            ))

    ws = plan.working_set_words()
    parts = plan.kernel_block_words() + plan.weight_scratch_words()
    if ws != parts:
        out.append(Finding(
            "plans", "ws-decomposition", sub,
            f"working_set_words()={ws} != kernel_block_words + "
            f"weight_scratch_words = {parts}",
        ))

    padded = plan.padded_shape(shape)
    for d, (s, p, b) in enumerate(zip(shape, padded, blocks)):
        if p % b != 0 or p < s or p - s >= b:
            out.append(Finding(
                "plans", "padding", sub,
                f"mode {d}: padded extent {p} is not the minimal "
                f"multiple of block {b} covering {s}",
            ))

    grid = plan.grid(shape)
    want = tuple(p // b for p, b in zip(padded, blocks))
    if grid != want or any(g < 1 for g in grid):
        out.append(Finding(
            "plans", "grid", sub,
            f"grid {grid} does not tile padded shape {padded}; "
            f"expected {want}",
        ))

    if plan.fits(memory):
        lb = max(
            multi_ttm_seq_lb_memory(shape, ranks, memory.budget_words), 0.0
        )
        model = plan.model_words(shape)
        if model < lb:
            out.append(Finding(
                "plans", "eq10-below-bound", sub,
                f"modeled traffic {model} words undercuts the Multi-TTM "
                f"sequential lower bound {lb:.0f} words at "
                f"M={memory.budget_words}",
            ))
    return out


def check_memory_itemsize(memory: Memory) -> list[Finding]:
    """Dtype-aware itemsize propagation: ``with_itemsize`` re-describes
    the same physical budget — bytes invariant, words = bytes // size."""
    out: list[Finding] = []
    for itemsize in (1, 2, 4, 8):
        m2 = memory.with_itemsize(itemsize)
        if m2.budget_bytes != memory.budget_bytes:
            out.append(Finding(
                "plans", "itemsize-propagation", repr(memory),
                f"with_itemsize({itemsize}) changed budget_bytes "
                f"{memory.budget_bytes} -> {m2.budget_bytes}",
            ))
        if m2.budget_words != memory.budget_bytes // itemsize:
            out.append(Finding(
                "plans", "itemsize-propagation", repr(memory),
                f"with_itemsize({itemsize}).budget_words = "
                f"{m2.budget_words}, expected "
                f"{memory.budget_bytes // itemsize}",
            ))
    return out


def check_batched_plans(
    shapes: Sequence[Sequence[int]] = DEFAULT_SHAPES,
    ranks: Sequence[int] = DEFAULT_RANKS,
    memories: Sequence[Memory] = DEFAULT_MEMORIES,
    batch_sizes: Sequence[int] = (1, 2, 4, 8),
    chooser=None,
) -> list[Finding]:
    """Rule ``batched-plan-divergence``: batching never changes the plan.

    The batched dispatch vmaps the element contraction, so the batch
    axis is a kernel grid dimension — no block spans two elements, and
    the per-instance Eq-9 working set is exactly the element working
    set.  Therefore for every ``B`` the batched planner
    (:func:`repro_torch.engine.plan.batched_choose_blocks`, or an injected
    ``chooser(B, shape, rank, itemsize, memory=...)``) must return a
    plan EQUAL to the ``B``-independent element plan, with identical
    ``working_set_words``.  A chooser that scales blocks or working set
    with ``B`` is statically rejected here.
    """
    if chooser is None:
        from ..engine.plan import batched_choose_blocks

        chooser = batched_choose_blocks
    findings: list[Finding] = []
    for shape in shapes:
        shape = tuple(shape)
        for memory in memories:
            itemsize = memory.itemsize
            for rank in ranks:
                base = choose_blocks(shape, rank, itemsize, memory=memory)
                for b in batch_sizes:
                    plan = chooser(b, shape, rank, itemsize, memory=memory)
                    subject = _subject(
                        "batched", plan, shape, f"B={b},rank={rank}"
                    )
                    if plan != base:
                        findings.append(Finding(
                            "plans", "batched-plan-divergence", subject,
                            f"batched plan at B={b} diverged from the "
                            f"element plan: {plan.blocks_per_mode()} != "
                            f"{base.blocks_per_mode()} "
                            f"(batching is vmap over the "
                            f"element contraction; the block choice "
                            f"must be B-independent)",
                        ))
                        continue
                    if plan.working_set_words() != \
                            base.working_set_words():
                        findings.append(Finding(
                            "plans", "batched-plan-divergence", subject,
                            f"batched working set at B={b} is "
                            f"{plan.working_set_words()}w, expected the "
                            f"B-independent {base.working_set_words()}w",
                        ))
    return findings


def _tucker_ranks(shape: Sequence[int]) -> tuple[int, ...]:
    return tuple(min(4, max(1, s // 2)) for s in shape[1:])


def verify_plans(
    shapes: Sequence[Sequence[int]] = DEFAULT_SHAPES,
    ranks: Sequence[int] = DEFAULT_RANKS,
    memories: Sequence[Memory] = DEFAULT_MEMORIES,
) -> list[Finding]:
    """Sweep the planners over the lattice and statically check every
    emitted plan (pure arithmetic — no arrays are ever built)."""
    findings: list[Finding] = []
    for memory in memories:
        findings += check_memory_itemsize(memory)
    for shape in shapes:
        shape = tuple(shape)
        for memory in memories:
            itemsize = memory.itemsize
            for rank in ranks:
                plan = choose_blocks(
                    shape, rank, itemsize, memory=memory
                )
                findings += check_block_plan(plan, shape, rank, memory)
                aug = choose_blocks(
                    shape, rank, itemsize, memory=memory, x_has_rank=True
                )
                findings += check_block_plan(aug, shape, rank, memory)
                sweep = choose_sweep_blocks(
                    shape, rank, itemsize, memory=memory
                )
                findings += check_sweep_plan(sweep, shape, rank, memory)
                b = best_uniform_block(shape, memory)
                if b >= 1 and not uniform_block_feasible(
                    len(shape), b, memory
                ):
                    findings.append(Finding(
                        "plans", "uniform-infeasible",
                        f"uniform[shape={shape},rank={rank}] b={b}",
                        f"best_uniform_block returned b={b} but Eq 9 "
                        f"rejects it at M={memory.budget_words}",
                    ))
            tranks = _tucker_ranks(shape)
            tplan = choose_multi_ttm_blocks(
                shape, tranks, itemsize, memory=memory
            )
            findings += check_multi_ttm_plan(tplan, shape, tranks, memory)
    findings += check_batched_plans(shapes, ranks, memories)
    return findings


# --------------------------------------------------------------------------
# The Hopper kernels' own plans
# --------------------------------------------------------------------------

#: The launch grid's limits (``csrc/common.cuh:MAX_BATCH``: the batch is
#: ``gridDim.z``; the splits are ``gridDim.y``).
GRID_YZ_MAX = 65535
GRID_X_MAX = 2 ** 31 - 1
KERNELS = ("mttkrp", "pair", "multi_ttm", "partial")


@dataclass(frozen=True)
class KernelCase:
    """One problem a Hopper kernel plans for: ``kernel`` in
    :data:`KERNELS`; ``shape`` the canonical problem (output or kept mode
    first; for ``"partial"`` the node's axis sizes, rank axis excluded,
    ``nkeep`` kept axes first, with their element ``strides``); ``rank`` R,
    or for ``"multi_ttm"`` the contracted modes' ranks; ``itemsize`` of the
    operands; ``batch`` problems in one launch."""

    kernel: str
    shape: tuple[int, ...]
    rank: int | tuple[int, ...]
    itemsize: int = 4
    batch: int = 1
    strides: tuple[int, ...] | None = None
    nkeep: int = 1

    @property
    def out_rank(self) -> int:
        """The rank columns a CTA tiles: R, or the last contracted rank."""
        return self.rank[-1] if isinstance(self.rank, tuple) else self.rank

    def __str__(self) -> str:
        extra = f",strides={self.strides}" if self.strides is not None else ""
        return (f"{self.kernel}[shape={self.shape},rank={self.rank},itemsize={self.itemsize},"
                f"batch={self.batch}{extra}]")


def choose_kernel_plan(case: KernelCase):
    """The kernel's own chooser on ``case``."""
    if case.kernel == "mttkrp":
        return choose_mttkrp_kernel_blocks(case.shape, case.rank, case.itemsize)
    if case.kernel == "pair":
        return choose_pair_kernel_blocks(case.shape, case.rank, case.itemsize)
    if case.kernel == "multi_ttm":
        return choose_multi_ttm_kernel_blocks(case.shape, case.rank, case.itemsize)
    if case.kernel == "partial":
        return choose_partial_kernel_blocks(case.shape, case.strides, case.rank, case.itemsize,
                                            nkeep=case.nkeep, batch=case.batch)
    raise ValueError(f"unknown kernel {case.kernel!r}; expected one of {KERNELS}")


def kernel_smem_bytes(case: KernelCase, plan) -> int:
    """The Python mirror of the kernel's dynamic shared memory under
    ``plan`` (the count ``chip_smoke.py`` holds against the library's)."""
    nc = len(case.shape) - 1
    if case.kernel == "mttkrp":
        return mttkrp_kernel_smem_bytes(plan, case.itemsize, nc)
    if case.kernel == "pair":
        return pair_kernel_smem_bytes(plan, case.itemsize, nc)
    if case.kernel == "multi_ttm":
        return multi_ttm_kernel_smem_bytes(plan, case.itemsize, case.rank)
    return partial_kernel_smem_bytes(plan, case.rank)


def _smallest_plan(case: KernelCase, plan):
    """The kernel's least shared memory at ``plan``'s rank tile (and
    layout): the smallest row block, the narrowest chunk, two stages; one
    row a CTA for the partial kernel (whose ``"rows"`` layout takes none).
    The reference's all-ones plan."""
    if case.kernel == "partial":
        return replace(plan, block_rows=1, loads=1, splits=1)
    return type(plan)(64, 32 // case.itemsize, plan.block_r, 2)


def kernel_launch(case: KernelCase, plan, sms: int = H100_SMS) -> dict:
    """The launch ``plan`` makes for ``case``: the grid function's
    ``(units, rank tiles, splits)``, the split count, the contraction's
    chunks (what a split takes), and the rows and rank columns the grid
    covers against the output's."""
    if case.kernel == "mttkrp":
        grid = mttkrp_kernel_grid(case.shape, case.rank, plan, sms, case.batch)
        chunks = math.prod(case.shape[1:-1]) * math.ceil(case.shape[-1] / plan.block_k)
        rows, row_block, col_block, splits = case.shape[0], plan.block_i, plan.block_r, grid[2]
    elif case.kernel == "pair":
        grid = pair_kernel_grid(case.shape, case.rank, plan, sms)
        chunks = math.prod(case.shape[1:-1])
        rows, row_block, col_block, splits = case.shape[0], plan.block_i, plan.block_r, grid[2]
    elif case.kernel == "multi_ttm":
        grid = multi_ttm_kernel_grid(case.shape, case.rank, plan, sms, case.batch)
        two_way = len(case.shape) == 2
        chunks = 1 if two_way else (math.prod(case.shape[1:-2])
                                    * math.ceil(case.shape[-2] / plan.block_m))
        # a unit is a tile of block_m rows (2-way) or one i
        rows, row_block = case.shape[0], plan.block_m if two_way else 1
        col_block, splits = plan.block_r, grid[2]
    else:
        grid = partial_kernel_grid(case.shape, case.rank, plan, case.nkeep)
        chunks = grid[2]
        rows, row_block = math.prod(case.shape[:case.nkeep]), plan.block_rows
        col_block, splits = plan.threads(case.rank)[0] * plan.vec, plan.splits
    return {"grid": tuple(grid), "splits": splits, "chunks": chunks, "rows": rows,
            "row_block": row_block, "cols": case.out_rank, "col_block": col_block,
            "launch": (grid[0] * grid[1], splits, case.batch)}


def check_kernel_plan(case: KernelCase, plan, launch: dict | None = None) -> list[Finding]:
    """All static checks for one kernel plan on one case; ``launch``
    (default :func:`kernel_launch`) may be injected to check a grid."""
    out: list[Finding] = []
    sub = f"{case} {plan!r}"
    try:
        if case.kernel == "partial":
            plan.check(case.rank, case.itemsize)
        else:
            plan.check(case.itemsize)
    except ValueError as e:
        out.append(Finding("plans", "kernel-plan-refused", sub, str(e)))
        return out  # the mirror and the grid read the plan's fields

    smem = kernel_smem_bytes(case, plan)
    if smem > SMEM_PER_CTA_MAX:
        out.append(Finding(
            "plans", "kernel-smem-over-cta", sub,
            f"shared memory {smem} bytes exceeds one CTA's {SMEM_PER_CTA_MAX}"))
    elif smem > SMEM_BUDGET:
        least = kernel_smem_bytes(case, _smallest_plan(case, plan))
        if least <= SMEM_BUDGET:
            out.append(Finding(
                "plans", "kernel-smem-over-budget", sub,
                f"shared memory {smem} bytes exceeds the budget {SMEM_BUDGET} (two CTAs an "
                f"SM) while the smallest plan takes {least}"))

    launch = launch if launch is not None else kernel_launch(case, plan)
    g = launch["grid"]
    for what, extent, block, tiles in (("rows", launch["rows"], launch["row_block"], g[0]),
                                       ("rank columns", launch["cols"], launch["col_block"],
                                        g[1])):
        covered = tiles * block
        if not extent <= covered < extent + block:
            out.append(Finding(
                "plans", "kernel-grid-cover", sub,
                f"{tiles} tiles of {block} {what} cover {covered}, not {extent} with less "
                f"than one block of slack"))

    splits, chunks = launch["splits"], launch["chunks"]
    if not 1 <= splits <= max(chunks, 1):
        out.append(Finding(
            "plans", "kernel-splits", sub,
            f"{splits} splits of a contraction of {chunks} chunks (1 to {chunks})"))

    x, y, z = launch["launch"]
    if not (1 <= x <= GRID_X_MAX and 1 <= y <= GRID_YZ_MAX and 1 <= z <= GRID_YZ_MAX):
        out.append(Finding(
            "plans", "kernel-grid-limit", sub,
            f"launch grid ({x}, {y}, {z}) exceeds ({GRID_X_MAX}, {GRID_YZ_MAX}, "
            f"{GRID_YZ_MAX}) (y: splits, z: the batch)"))
    return out


def _node(dims: Sequence[int], rank: int, keep: int, contract: Sequence[int],
          itemsize: int, batch: int = 1, canonical: bool = False) -> KernelCase:
    """A partial-kernel case: kept axis ``keep`` of a row-major node of
    axis sizes ``dims`` with the rank axis last, contracting ``contract``
    (in that order), read in place (or as its canonical copy)."""
    axes = (keep,) + tuple(contract)
    if canonical:
        sizes = tuple(dims[a] for a in axes)
        strides = tuple(math.prod(sizes[i + 1:]) * rank for i in range(len(sizes)))
    else:
        strides_all = [math.prod(dims[i + 1:]) * rank for i in range(len(dims))]
        strides = tuple(strides_all[a] for a in axes)
    return KernelCase("partial", tuple(dims[a] for a in axes), rank, itemsize, batch, strides)


def default_kernel_cases() -> tuple[KernelCase, ...]:
    """The kernel-plan lattice: the port's cells (``PERF.md`` section 4)
    and their contractions on every kernel, in fp32 and bf16, plus the
    2-way cases, the distributed blocks, the batched cells and ragged
    small problems."""
    cases: list[KernelCase] = []
    for itemsize in (4, 2):
        mttkrp = [((1000, 1000, 1000), 64), ((180, 180, 180, 180), 32),
                  ((32400, 180, 180), 32), ((10000, 10000), 64), ((1000, 1000), 64),
                  ((500, 1000, 500), 64), ((24, 10, 12), 4), ((7, 5, 3), 1),
                  ((200, 3, 130), 16), ((16, 8, 6, 4), 64), ((1000, 1000, 1000), 130)]
        cases += [KernelCase("mttkrp", s, r, itemsize) for s, r in mttkrp]
        cases += [KernelCase("mttkrp", (256, 256, 256), 32, itemsize, 16),
                  KernelCase("mttkrp", (96, 96, 96), 16, itemsize, 64),
                  KernelCase("mttkrp", (64, 64, 64, 64), 16, itemsize, 8)]
        pair = [((1000, 1000, 1000), 64), ((180, 180, 180, 180), 32), ((24, 10, 12), 4),
                ((200, 3, 130), 16)]
        cases += [KernelCase("pair", s, r, itemsize) for s, r in pair]
        ttm = [((1000, 1000, 1000), (32, 32)), ((1000, 1000, 1000), (16, 16)),
               ((180, 180, 180, 180), (16, 16, 16)), ((1000, 500, 500), (32, 32)),
               ((500, 1000, 500), (32, 32)), ((1000, 1000), (32,)), ((10000, 10000), (16,)),
               ((24, 10, 12), (3, 2)), ((16, 8, 6, 4), (4, 3, 2))]
        cases += [KernelCase("multi_ttm", s, r, itemsize) for s, r in ttm]
        cases += [KernelCase("multi_ttm", (256, 256, 256), (16, 16), itemsize, 16),
                  KernelCase("multi_ttm", (64, 64, 64, 64), (16, 16, 16), itemsize, 8)]
        # the partial kernel's nodes: k = 1 on 1000^3's (I0, I1, R) nodes,
        # k = 2 on 180^4's (180, 180, 180, R) P and k = 1 on its 4 MB leaves,
        # each read in place and as its canonical copy
        for canonical in (False, True):
            cases += [_node((1000, 1000), 64, 0, (1,), itemsize, canonical=canonical),
                      _node((1000, 1000), 64, 1, (0,), itemsize, canonical=canonical),
                      _node((180, 180, 180), 32, 0, (1, 2), itemsize, canonical=canonical),
                      _node((180, 180, 180), 32, 1, (0, 2), itemsize, canonical=canonical),
                      _node((180, 180, 180), 32, 2, (0, 1), itemsize, canonical=canonical),
                      _node((180, 180), 32, 0, (1,), itemsize, canonical=canonical),
                      _node((180, 180), 32, 1, (0,), itemsize, canonical=canonical),
                      _node((24, 10), 7, 1, (0,), itemsize, canonical=canonical)]
        cases += [_node((256, 256), 32, 0, (1,), itemsize, 16),
                  _node((256, 256), 32, 1, (0,), itemsize, 16),
                  _node((64, 64, 64), 16, 2, (0, 1), itemsize, 8)]
    return tuple(cases)


def kernel_plan_verdicts(
    cases: Sequence[KernelCase] | None = None,
) -> tuple[list[Finding], list[dict]]:
    """Run every kernel's chooser over the lattice (default
    :func:`default_kernel_cases`) and statically check each plan: the
    findings (a chooser that raises is one, ``kernel-no-plan``) and one
    verdict a case (its plan, shared memory and launch)."""
    findings: list[Finding] = []
    verdicts: list[dict] = []
    for case in cases if cases is not None else default_kernel_cases():
        verdict = {"analyzer": "plans", "name": case.kernel, "shape": list(case.shape),
                   "rank": case.rank if isinstance(case.rank, int) else list(case.rank),
                   "itemsize": case.itemsize, "batch": case.batch, "backend": "cuda"}
        try:
            plan = choose_kernel_plan(case)
        except ValueError as e:
            findings.append(Finding("plans", "kernel-no-plan", str(case), str(e)))
            verdicts.append({**verdict, "plan": None, "agrees": False, "findings": 1})
            continue
        found = check_kernel_plan(case, plan)
        findings += found
        verdicts.append({**verdict, "plan": repr(plan), "smem_bytes": kernel_smem_bytes(case, plan),
                         "launch": list(kernel_launch(case, plan)["launch"]),
                         "agrees": not found, "findings": len(found)})
    return findings, verdicts


def check_kernel_plans(cases: Sequence[KernelCase] | None = None) -> list[Finding]:
    """The findings of :func:`kernel_plan_verdicts`."""
    return kernel_plan_verdicts(cases)[0]
