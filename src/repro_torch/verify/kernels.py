"""Kernel coverage analysis: prove each Hopper kernel's tile walk, run nothing.
Counterpart of ``repro.verify.kernels``.

The reference captures every ``pallas_call``'s grid and ``BlockSpec`` index
maps under ``jax.eval_shape`` and enumerates them. A CUDA kernel declares
neither: its grid comes from a C function and its ``blockIdx`` to output
arithmetic lives in the kernel body. So this module writes each kernel's
walk down in Python, once: for every ``(blockIdx.x, y, z)`` of the launch,
the boxes of each buffer that CTA stores (a buffer is the output, a split-K
workspace, or the pair's P), taken from the grid mirrors of
:mod:`repro_torch.engine.plan` and the index arithmetic of the ``.cu``
files, masks included:

* ``mttkrp_mma_kernel`` (``csrc/mttkrp.cu``, 3-way and N-way): row tile
  ``blockIdx.x / rank tiles``, rank tile ``% rank tiles``, split ``y`` the
  slab ``(y, z)`` of an ``(S, B, I, R)`` workspace;
* ``splitk_reduce_kernel`` (``mttkrp.cu``): a grid-stride loop, every
  output once for any grid;
* ``fused_pair_mma_kernel`` (``csrc/sweep.cu``): B0's slab ``y`` and P's
  tuples ``y, y + S, ...``;
* ``streaming_partial_kernel`` (``sweep.cu``): both layouts, rows past the
  node and rank columns past R masked;
* ``multi_ttm_mma_kernel`` (``csrc/multi_ttm.cu``): one i (or a row tile
  for k = 1) and a rank tile of ``R_k`` a CTA;
* ``ssd_intra_kernel`` (``csrc/ssd_intra.cu``): a row tile of one chunk
  and a block of heads a CTA, row tiles taken from the last.

The rules, each with its code:

* ``grid`` — no dimension is degenerate; ``gridDim.y`` and ``gridDim.z``
  are at most 65,535 and ``gridDim.x`` below 2^31;
* ``oob-origin`` — no box lies outside its buffer (or is empty);
* ``coverage-gap`` — every element of every buffer is written (each is
  read afterwards: the slabs by the reduction, the rest by the caller);
* ``write-once`` — no element is written twice, by two CTAs or by one (on
  Hopper the grid runs in parallel: a second write is a race, where the
  reference's rule, ``noncontiguous-revisit``, looked for a torn
  accumulation run of a sequential grid);
* ``acc-dtype`` — the MTTKRP, pair, partial and Multi-TTM kernels write
  float32 for float32 and bfloat16 operands; ``ssd_intra`` writes X's
  dtype, as its Pallas kernel does;
* ``footprint`` — the plan's shared memory (the Python mirror of the
  kernel's own count) fits one CTA; the verdict carries it, where the
  reference's carried the ``BlockSpec`` footprint;
* ``kernel-executed`` — no wrapper's launch count moves during the
  analysis.

Writes are counted with numpy over the boxes, not element by element:
each axis is cut at every box edge, a difference array over those cells
takes one +1/-1 corner per box, and prefix sums give the count of every
cell (so ``ssd_intra``'s 84 M outputs at the served shape are a few
hundred cells). ``chip_smoke.py`` holds the walks against the kernels on
the card: each C launcher's grid function (``repro_*_grid``) against the
mirror, and a build of each kernel with a per-element write counter
(``kernels/build.py:write_probe``) against the counts predicted here.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..engine.plan import (
    H100_SMS,
    SMEM_PER_CTA_MAX,
    MTTKRPKernelPlan,
    MultiTTMKernelPlan,
    PartialKernelPlan,
    choose_multi_ttm_kernel_blocks,
    choose_mttkrp_kernel_blocks,
    choose_pair_kernel_blocks,
    choose_partial_kernel_blocks,
    multi_ttm_kernel_grid,
    mttkrp_kernel_grid,
    pair_kernel_grid,
    partial_kernel_grid,
    ssd_intra_kernel_grid,
)
from . import Finding
from .plans import GRID_X_MAX, GRID_YZ_MAX

#: ``splitk_reduce_kernel``'s CTA and its cap on CTAs (``mttkrp.cu:splitk_grid``).
SPLITK_THREADS = 256
SPLITK_MAX_CTAS = 132 * 32
#: The wrappers, by the name their launch counts go under.
WRAPPERS = ("mttkrp3", "mttkrpn", "splitk_reduce", "fused_pair", "mttkrp_partial",
            "multi_ttm_keep", "ssd_intra")
#: The kernel each wrapper launches.
KERNEL_OF = {
    "mttkrp3": "mttkrp_mma_kernel<T, 2, MT, NT>",
    "mttkrpn": "mttkrp_mma_kernel<T, 0, MT, NT>",
    "splitk_reduce": "splitk_reduce_kernel",
    "fused_pair": "fused_pair_mma_kernel<T, MT, NT>",
    "mttkrp_partial": "streaming_partial_kernel<T, V, ROWL, ROWS>",
    "multi_ttm_keep": "multi_ttm_mma_kernel<T, MT, NT>",
    "ssd_intra": "ssd_intra_kernel<T>",
}


@dataclass(frozen=True)
class Buffer:
    """A buffer a kernel writes: its name, shape and dtype."""

    name: str
    shape: tuple[int, ...]
    dtype: str

    def to_dict(self) -> dict:
        return {"name": self.name, "shape": list(self.shape), "dtype": self.dtype}


@dataclass
class Walk:
    """One launch's writes: the grid, the buffers, and for each buffer the
    boxes ``(n, ndim, 2)`` of ``[start, stop)`` per axis that the CTAs
    ``ctas[name]`` (``(n, 3)``: x, y, z) store."""

    grid: tuple[int, int, int]
    buffers: tuple[Buffer, ...]
    boxes: dict
    ctas: dict


@dataclass(frozen=True)
class WalkCase:
    """One launch to prove: ``wrapper`` in :data:`WRAPPERS`; ``shape`` the
    canonical problem (output or kept mode first; for ``mttkrp_partial``
    the node's axis sizes, rank axis excluded, ``nkeep`` kept axes first,
    with their element ``strides``; for ``ssd_intra`` ``(BC, q, N, H, P)``;
    for ``splitk_reduce`` ``(S, n)``: slabs and outputs); ``rank`` R, or the
    Multi-TTM's ranks; ``itemsize`` of the operands; ``batch`` problems in
    one launch; ``plan`` pinned, or None for the wrapper's chooser;
    ``shared`` whether a batch shares its factors (the walk is the same;
    the card's probe feeds both); ``label`` what the case stands for."""

    wrapper: str
    shape: tuple[int, ...]
    rank: int | tuple[int, ...] = 0
    itemsize: int = 4
    batch: int = 1
    plan: object = None
    strides: tuple[int, ...] | None = None
    nkeep: int = 1
    shared: bool = False
    label: str = ""

    def __str__(self) -> str:
        extra = f",strides={self.strides}" if self.strides is not None else ""
        return (f"{self.wrapper}[shape={self.shape},rank={self.rank},itemsize={self.itemsize},"
                f"batch={self.batch}{extra}]")


def _dtype(itemsize: int) -> str:
    return "float32" if itemsize == 4 else "bfloat16"


def case_plan(case: WalkCase, sms: int = H100_SMS):
    """The case's plan: pinned, or the one its wrapper chooses."""
    if case.plan is not None or case.wrapper == "splitk_reduce":
        return case.plan
    if case.wrapper in ("mttkrp3", "mttkrpn"):
        return choose_mttkrp_kernel_blocks(case.shape, case.rank, case.itemsize)
    if case.wrapper == "fused_pair":
        return choose_pair_kernel_blocks(case.shape, case.rank, case.itemsize)
    if case.wrapper == "multi_ttm_keep":
        return choose_multi_ttm_kernel_blocks(case.shape, case.rank, case.itemsize)
    if case.wrapper == "mttkrp_partial":
        return choose_partial_kernel_blocks(case.shape, case.strides, case.rank, case.itemsize,
                                            sms, nkeep=case.nkeep, batch=case.batch)
    if case.wrapper == "ssd_intra":
        from ..kernels.ssd_intra import kernel_plan

        bcn, q, _, h, p = case.shape
        return kernel_plan(q, h, p, case.itemsize, bcn=bcn, sms=sms)
    raise ValueError(f"unknown wrapper {case.wrapper!r}; expected one of {WRAPPERS}")


def smem_bytes(case: WalkCase, plan) -> int:
    """The Python mirror of the kernel's dynamic shared memory under
    ``plan`` (``verify.plans.kernel_smem_bytes``; ``ssd_intra``'s
    ``kernel_smem_bytes``; none for the reduction)."""
    if case.wrapper == "splitk_reduce":
        return 0
    if case.wrapper == "ssd_intra":
        from ..kernels.ssd_intra import kernel_smem_bytes

        _, q, _, _, p = case.shape
        return kernel_smem_bytes(q, p, plan.tile, case.itemsize)
    from .plans import KernelCase, kernel_smem_bytes

    kernel = {"mttkrp3": "mttkrp", "mttkrpn": "mttkrp", "fused_pair": "pair",
              "multi_ttm_keep": "multi_ttm", "mttkrp_partial": "partial"}[case.wrapper]
    return kernel_smem_bytes(KernelCase(kernel, case.shape, case.rank, case.itemsize, case.batch,
                                        case.strides, case.nkeep), plan)


# --------------------------------------------------------------------------
# The walks
# --------------------------------------------------------------------------

def _ctas(grid: Sequence[int]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every CTA of ``grid``, x fastest."""
    z, y, x = np.meshgrid(*(np.arange(g, dtype=np.int64) for g in reversed(grid)),
                          indexing="ij")
    return x.ravel(), y.ravel(), z.ravel()


def _boxes(*axes) -> np.ndarray:
    """Boxes from per-axis ``(start, stop)`` arrays (or scalars)."""
    n = max(np.size(a) for pair in axes for a in pair)
    return np.stack([np.stack([np.broadcast_to(np.asarray(lo, np.int64), (n,)),
                               np.broadcast_to(np.asarray(hi, np.int64), (n,))], axis=1)
                     for lo, hi in axes], axis=1)


def _cta_array(x, y, z) -> np.ndarray:
    n = max(np.size(x), np.size(y), np.size(z))
    return np.stack([np.broadcast_to(np.asarray(v, np.int64), (n,)) for v in (x, y, z)], axis=1)


def _slab_name(splits: int) -> str:
    return "ws" if splits > 1 else "out"


def mttkrp_walk(shape: Sequence[int], rank: int, plan: MTTKRPKernelPlan, sms: int = H100_SMS,
                batch: int = 1) -> Walk:
    """``mttkrp_mma_kernel`` (``mttkrp.cu:80-90,311-322``): CTA ``(x, y,
    z)`` stores rows ``[i0, min(i0 + BI, I))`` (``gi >= extent_i`` skipped)
    and rank columns ``[r0, r0 + rvalid)`` of slab ``(y, z)``, ``i0 = x /
    gr * BI``, ``r0 = x % gr * BR``. Every split writes its slab, one with
    no chunks (``y`` past the chunks) zeros."""
    extent_i = int(shape[0])
    rows, rtiles, splits = mttkrp_kernel_grid(shape, rank, plan, sms, batch)
    grid = (rows * rtiles, splits, batch)
    x, y, z = _ctas(grid)
    i0 = x // rtiles * plan.block_i
    r0 = x % rtiles * plan.block_r
    buf = Buffer(_slab_name(splits), (splits, batch, extent_i, rank), "float32")
    boxes = _boxes((y, y + 1), (z, z + 1), (i0, np.minimum(i0 + plan.block_i, extent_i)),
                   (r0, r0 + np.minimum(plan.block_r, rank - r0)))
    return Walk(grid, (buf,), {buf.name: boxes}, {buf.name: _cta_array(x, y, z)})


def splitk_walk(n: int) -> Walk:
    """``splitk_reduce_kernel`` (``mttkrp.cu:327-333``): thread t of CTA x
    stores ``e = x * 256 + t + k * stride``, ``stride`` the grid's threads,
    for every ``k`` with ``e < n``: 256-element runs, run c taken by CTA
    ``c % gridDim.x``."""
    ctas = min(-(-n // SPLITK_THREADS), SPLITK_MAX_CTAS)
    grid = (ctas, 1, 1)
    start = np.arange(0, n, SPLITK_THREADS, dtype=np.int64)
    x = start // SPLITK_THREADS % ctas
    buf = Buffer("out", (n,), "float32")
    return Walk(grid, (buf,), {"out": _boxes((start, np.minimum(start + SPLITK_THREADS, n)))},
                {"out": _cta_array(x, 0, 0)})


def pair_walk(shape: Sequence[int], rank: int, plan: MTTKRPKernelPlan,
              sms: int = H100_SMS) -> Walk:
    """``fused_pair_mma_kernel`` (``sweep.cu:102-106,160-168,221-233``): CTA
    ``(x, y)`` stores its rows and rank columns of B0's slab ``y`` and, for
    each of its tuples ``pf = y, y + S, ...`` below ``prod C[:-1]``, of
    ``P[:, pf, :]``."""
    extent_i, npf = int(shape[0]), math.prod(shape[1:-1])
    rows, rtiles, splits = pair_kernel_grid(shape, rank, plan, sms)
    grid = (rows * rtiles, splits, 1)
    x, y, _ = _ctas(grid)
    i0 = x // rtiles * plan.block_i
    r0 = x % rtiles * plan.block_r
    i1 = np.minimum(i0 + plan.block_i, extent_i)
    r1 = r0 + np.minimum(plan.block_r, rank - r0)
    b0 = Buffer("b0_" + _slab_name(splits), (splits, extent_i, rank), "float32")
    p = Buffer("p", (extent_i, npf, rank), "float32")
    # P: every row tile x rank tile, every tuple, written by the split that owns the tuple
    px, pf = (a.ravel() for a in np.meshgrid(np.arange(rows * rtiles, dtype=np.int64),
                                             np.arange(npf, dtype=np.int64), indexing="ij"))
    pi0, pr0 = px // rtiles * plan.block_i, px % rtiles * plan.block_r
    p_boxes = _boxes((pi0, np.minimum(pi0 + plan.block_i, extent_i)), (pf, pf + 1),
                     (pr0, pr0 + np.minimum(plan.block_r, rank - pr0)))
    return Walk(grid, (b0, p),
                {b0.name: _boxes((y, y + 1), (i0, i1), (r0, r1)), "p": p_boxes},
                {b0.name: _cta_array(x, y, 0), "p": _cta_array(px, pf % splits, 0)})


def partial_walk(shape: Sequence[int], rank: int, plan: PartialKernelPlan, nkeep: int = 1,
                 batch: int = 1) -> Walk:
    """``streaming_partial_kernel`` (``sweep.cu:318-352,430-470``): CTA
    ``(x, y, z)`` owns row block ``rb = x / rtiles`` and rank tile ``rt = x
    % rtiles``. Thread ``tid`` is r-vector ``tri = tid % tr`` (columns
    ``r0 = (rt tr + tri) V`` to ``r0 + V``, stored where ``r0 < R``) and
    lane thread ``tl = tid / tr``: under ``"rows"`` its rows are ``rb
    block_rows + tl + j TL``, ``j < ROWS``; under ``"contract"`` the CTA's
    fold stores rows ``rb block_rows + j`` and columns ``rt tr V + col``;
    rows past the node are skipped either way. Slab ``(y, z)``."""
    rows = math.prod(shape[:nkeep])
    rblocks, rtiles, _ = partial_kernel_grid(shape, rank, plan, nkeep)
    tr, tl, _ = plan.threads(rank)
    grid = (rblocks * rtiles, plan.splits, batch)
    x, y, z = _ctas(grid)
    rb, rt = x // rtiles, x % rtiles
    if plan.layout == "rows":
        lo = rb * plan.block_rows  # tl = 0, j = 0
        hi = lo + (tl - 1) + (plan.rows_per_thread(rank) - 1) * tl + 1
    else:
        lo = rb * plan.block_rows
        hi = lo + plan.block_rows
    # the r-vectors of the rank tile that start inside R (V divides R where V > 1)
    c0 = rt * tr * plan.vec
    c1 = np.minimum(c0 + tr * plan.vec, -(-rank // plan.vec) * plan.vec)
    buf = Buffer(_slab_name(plan.splits), (plan.splits, batch, rows, rank), "float32")
    boxes = _boxes((y, y + 1), (z, z + 1), (lo, np.minimum(hi, rows)), (c0, c1))
    return Walk(grid, (buf,), {buf.name: boxes}, {buf.name: _cta_array(x, y, z)})


def multi_ttm_walk(shape: Sequence[int], ranks: Sequence[int], plan: MultiTTMKernelPlan,
                   sms: int = H100_SMS, batch: int = 1) -> Walk:
    """``multi_ttm_mma_kernel`` (``multi_ttm.cu:115-132,175-187,395-400``):
    CTA ``(x, y, z)`` owns unit ``x / gr`` and the rank tile ``r0 = x % gr
    BR`` of ``R_k``; for k >= 2 it stores, after its tiles, the whole O(i, :)
    of ``prod R[:-1]`` rows at columns ``[r0, r0 + rvalid)`` of slab ``(y,
    z)`` of an ``(S, B, I, prod R[:-1], R_k)`` workspace (a split with no
    tiles stores zeros); for k = 1 the unit is a tile of ``block_m`` rows,
    rows past I skipped."""
    extent_i, k, rl = int(shape[0]), len(ranks), int(ranks[-1])
    units, rtiles, splits = multi_ttm_kernel_grid(shape, ranks, plan, sms, batch)
    grid = (units * rtiles, splits, batch)
    x, y, z = _ctas(grid)
    unit, r0 = x // rtiles, x % rtiles * plan.block_r
    r1 = r0 + np.minimum(plan.block_r, rl - r0)
    if k >= 2:
        lead = math.prod(ranks[:-1])
        buf = Buffer(_slab_name(splits), (splits, batch, extent_i, lead, rl), "float32")
        boxes = _boxes((y, y + 1), (z, z + 1), (unit, unit + 1), (0, lead), (r0, r1))
    else:
        buf = Buffer("out", (1, batch, extent_i, rl), "float32")
        i0 = unit * plan.block_m
        boxes = _boxes((y, y + 1), (z, z + 1), (i0, np.minimum(i0 + plan.block_m, extent_i)),
                       (r0, r1))
    return Walk(grid, (buf,), {buf.name: boxes}, {buf.name: _cta_array(x, y, z)})


def ssd_walk(bcn: int, q: int, h: int, p: int, plan, itemsize: int = 2) -> Walk:
    """``ssd_intra_kernel`` (``ssd_intra.cu:195-199,455-486``): CTA x takes
    row tile ``it = n_it - 1 - x / (BC H / heads)`` (the longest first),
    chunk ``c = x % (BC H / heads) / (H / heads)`` and heads ``h0 = x %
    (H / heads) heads`` to ``h0 + heads``, and stores rows ``[it t,
    min(it t + t, q))`` (``gi < q``) and every column of P (``col < P``) of
    each of its heads, in X's dtype."""
    tile, heads = plan.tile, plan.heads
    grid = ssd_intra_kernel_grid(bcn, q, h, tile, heads)
    n_it, hblocks = -(-q // tile), h // heads
    per_it = bcn * hblocks
    x = np.arange(grid[0], dtype=np.int64)
    it = n_it - 1 - x // per_it
    c = x % per_it // hblocks
    h0 = x % hblocks * heads
    buf = Buffer("out", (bcn, q, h, p), _dtype(itemsize))
    boxes = _boxes((c, c + 1), (it * tile, np.minimum(it * tile + tile, q)), (h0, h0 + heads),
                   (0, p))
    return Walk(grid, (buf,), {"out": boxes}, {"out": _cta_array(x, 0, 0)})


def case_walk(case: WalkCase, plan=None, sms: int = H100_SMS) -> Walk:
    """The walk of ``case`` under ``plan`` (default :func:`case_plan`)."""
    plan = plan if plan is not None else case_plan(case, sms)
    w = case.wrapper
    if w in ("mttkrp3", "mttkrpn"):
        return mttkrp_walk(case.shape, case.rank, plan, sms, case.batch)
    if w == "splitk_reduce":
        return splitk_walk(int(case.shape[1]))
    if w == "fused_pair":
        return pair_walk(case.shape, case.rank, plan, sms)
    if w == "mttkrp_partial":
        return partial_walk(case.shape, case.rank, plan, case.nkeep, case.batch)
    if w == "multi_ttm_keep":
        return multi_ttm_walk(case.shape, case.rank, plan, sms, case.batch)
    if w == "ssd_intra":
        bcn, q, _, h, p = case.shape
        return ssd_walk(bcn, q, h, p, plan, case.itemsize)
    raise ValueError(f"unknown wrapper {w!r}; expected one of {WRAPPERS}")


# --------------------------------------------------------------------------
# Counting and the rules
# --------------------------------------------------------------------------

def count_writes(shape: Sequence[int], boxes: np.ndarray) -> tuple[list, np.ndarray, np.ndarray]:
    """The writes of ``boxes`` (in-range, non-empty) into a buffer of
    ``shape``: each axis cut at every box edge; returns the cuts, the count
    of each cell and each cell's elements."""
    d = len(shape)
    cuts, lo, hi = [], [], []
    for a in range(d):
        cut = np.unique(np.concatenate(([0, shape[a]], boxes[:, a, 0], boxes[:, a, 1])))
        cuts.append(cut)
        lo.append(np.searchsorted(cut, boxes[:, a, 0]))
        hi.append(np.searchsorted(cut, boxes[:, a, 1]))
    cells = tuple(len(c) - 1 for c in cuts)
    size = math.prod(c + 1 for c in cells)
    diff = np.zeros(size, dtype=np.int64)
    for corner in itertools.product((0, 1), repeat=d):
        flat = np.ravel_multi_index(tuple(hi[a] if corner[a] else lo[a] for a in range(d)),
                                    tuple(c + 1 for c in cells))
        diff += (-1) ** sum(corner) * np.bincount(flat, minlength=size)
    counts = diff.reshape(tuple(c + 1 for c in cells))
    for a in range(d):
        counts = np.cumsum(counts, axis=a)
    counts = counts[tuple(slice(0, c) for c in cells)]
    elems = np.ones(cells, dtype=np.int64)
    for a in range(d):
        elems = elems * np.diff(cuts[a]).reshape((1,) * a + (-1,) + (1,) * (d - a - 1))
    return cuts, counts, elems


def check_walk(walk: Walk, subject: str, *, expect_dtype: str = "float32",
               smem: int = 0) -> tuple[list[Finding], dict]:
    """All rules on one walk; returns the findings and the counts
    (``writes_checked``, the elements; ``max_count``)."""
    out: list[Finding] = []
    stats = {"writes_checked": 0, "max_count": 0}
    x, y, z = walk.grid
    if not (1 <= x <= GRID_X_MAX and 1 <= y <= GRID_YZ_MAX and 1 <= z <= GRID_YZ_MAX):
        out.append(Finding("kernels", "grid", subject,
                           f"launch grid {walk.grid} outside (1..{GRID_X_MAX}, "
                           f"1..{GRID_YZ_MAX}, 1..{GRID_YZ_MAX})"))
        return out, stats
    if smem > SMEM_PER_CTA_MAX:
        out.append(Finding("kernels", "footprint", subject,
                           f"shared memory {smem} bytes exceeds one CTA's {SMEM_PER_CTA_MAX}"))
    for buf in walk.buffers:
        sub = f"{subject}:{buf.name}"
        if buf.dtype != expect_dtype:
            out.append(Finding("kernels", "acc-dtype", sub,
                               f"writes {buf.dtype}, the policy requires {expect_dtype}"))
        boxes, ctas = walk.boxes[buf.name], walk.ctas[buf.name]
        ext = np.asarray(buf.shape, dtype=np.int64)
        bad = np.flatnonzero(((boxes[:, :, 0] < 0) | (boxes[:, :, 1] > ext)
                              | (boxes[:, :, 1] <= boxes[:, :, 0])).any(axis=1))
        if bad.size:
            i = int(bad[0])
            out.append(Finding("kernels", "oob-origin", sub,
                               f"{bad.size} box(es) outside the {buf.shape} buffer or empty "
                               f"(first: CTA {tuple(int(v) for v in ctas[i])} writes "
                               f"{[tuple(int(v) for v in b) for b in boxes[i]]})"))
            continue
        _, counts, elems = count_writes(buf.shape, boxes)
        stats["writes_checked"] += int(elems.sum())
        stats["max_count"] = max(stats["max_count"], int(counts.max(initial=0)))
        gap = int(elems[counts == 0].sum())
        if gap:
            out.append(Finding("kernels", "coverage-gap", sub,
                               f"{gap} of {math.prod(buf.shape)} elements never written"))
        twice = int(elems[counts > 1].sum())
        if twice:
            out.append(Finding("kernels", "write-once", sub,
                               f"{twice} elements written more than once (up to "
                               f"{int(counts.max())} times)"))
    return out, stats


# --------------------------------------------------------------------------
# The lattice
# --------------------------------------------------------------------------

def _node(dims: Sequence[int], rank: int, keep: int, contract: Sequence[int], itemsize: int,
          batch: int = 1, canonical: bool = False, plan=None, label: str = "") -> WalkCase:
    """A partial-kernel case: kept axis ``keep`` of a row-major node of axis
    sizes ``dims`` (the rank axis last), contracting ``contract``, read in
    place (or as its canonical copy)."""
    from .plans import _node as plan_node

    c = plan_node(dims, rank, keep, contract, itemsize, batch, canonical)
    return WalkCase("mttkrp_partial", c.shape, rank, itemsize, batch, plan, c.strides, 1,
                    label=label)


def kernel_cases() -> list[WalkCase]:
    """The launches the analyzer proves: the reference's five cases at their
    shapes (in bf16, through the port's choosers or pinned port plans with
    multi-block grids), the port's cells, ragged edges, R of 7 and 130, 2-way
    problems, batches of 16 (shared and per-element factors) and of 65,535,
    and the split-K reductions of the split cells' workspaces."""
    cases = [
        # the reference's five (repro/verify/kernels.py:kernel_cases), and its SSD kernel
        WalkCase("mttkrp3", (24, 10, 12), 7, 2, label="reference"),
        WalkCase("mttkrpn", (8, 4, 5, 6), 5, 2, label="reference"),
        WalkCase("mttkrp_partial", (12, 4, 6), 5, 2, strides=(120, 30, 5),
                 plan=PartialKernelPlan("contract", 4, 1, 8, 3), label="reference"),
        WalkCase("multi_ttm_keep", (16, 6, 10), (3, 2), 2, label="reference"),
        WalkCase("fused_pair", (12, 6, 8), 5, 2, label="reference"),
        WalkCase("ssd_intra", (2, 40, 20, 4, 24), 0, 2, label="reference"),
    ]
    # the port's cells (PERF.md section 4)
    for itemsize in (4, 2):
        cases.append(WalkCase("mttkrp3", (1000, 1000, 1000), 64, itemsize, label="cell"))
        cases.append(WalkCase("multi_ttm_keep", (1000, 1000, 1000), (32, 32), itemsize,
                              label="cell: keep 0 and the core"))
        cases.append(WalkCase("ssd_intra", (64, 256, 128, 80, 64), 0, itemsize,
                              label="cell: mamba2-2.7b prefill"))
    cases += [
        WalkCase("mttkrpn", (180, 180, 180, 180), 32, 4, label="cell"),
        WalkCase("fused_pair", (1000, 1000, 1000), 64, 4, label="cell"),
        WalkCase("fused_pair", (180, 180, 180, 180), 32, 4, label="cell"),
        _node((1000, 1000), 64, 0, (1,), 4, label="cell: k=1 in place"),
        _node((1000, 1000), 64, 1, (0,), 4, label="cell: k=1 in place"),
        _node((180, 180, 180), 32, 0, (1, 2), 4, label="cell: k=2 in place"),
        _node((180, 180, 180), 32, 1, (0, 2), 4, label="cell: k=2 in place"),
        _node((180, 180, 180), 32, 2, (0, 1), 4, canonical=True, label="cell: k=2 canonical"),
        WalkCase("multi_ttm_keep", (180, 180, 180, 180), (16, 16, 16), 4, label="cell"),
    ]
    # the split-K reductions of the cells' workspaces: (slabs, outputs)
    for case in [c for c in cases if c.wrapper in ("mttkrp3", "mttkrpn") and c.label == "cell"]:
        plan = case_plan(case)
        splits = mttkrp_kernel_grid(case.shape, case.rank, plan)[2]
        cases.append(WalkCase("splitk_reduce", (splits, case.shape[0] * case.rank), 0, 4,
                              label="cell workspace"))
    # ragged edges: I, R, q and P off the tile; R of 7 and 130; 2-way problems
    cases += [
        WalkCase("mttkrp3", (200, 3, 130), 16, 4, label="ragged I"),
        WalkCase("mttkrp3", (130, 70, 50), 7, 4, label="R of 7"),
        WalkCase("mttkrp3", (300, 40, 40), 130, 2, label="R of 130"),
        WalkCase("mttkrpn", (10000, 10000), 64, 4, label="2-way"),
        WalkCase("mttkrpn", (9, 40), 6, 4, label="2-way ragged"),
        WalkCase("mttkrpn", (70, 9, 11, 13), 33, 2, label="ragged 4-way"),
        WalkCase("fused_pair", (70, 9, 20), 6, 4, label="ragged"),
        WalkCase("fused_pair", (300, 7, 5, 33), 130, 2, label="R of 130"),
        WalkCase("multi_ttm_keep", (1000, 1000), (32,), 4, label="2-way"),
        WalkCase("multi_ttm_keep", (70, 20), (5,), 4, plan=MultiTTMKernelPlan(64, 8, 16, 2),
                 label="k=1 ragged"),
        WalkCase("multi_ttm_keep", (4, 3, 70, 24), (2, 3, 5), 4, label="ragged 4-way"),
        WalkCase("multi_ttm_keep", (3, 2, 150, 20), (2, 3, 130), 2, label="R_k of 130"),
        _node((13, 37), 32, 0, (1,), 4, plan=PartialKernelPlan("contract", 8, 4, 8, 3),
              label="ragged contract"),
        _node((45, 19), 32, 1, (0,), 4, plan=PartialKernelPlan("rows", 64, 4, 8, 4),
              label="ragged rows"),
        _node((9, 11), 300, 0, (1,), 4, plan=PartialKernelPlan("contract", 2, 4, 8, 2),
              label="R of 300"),
        _node((300, 9), 7, 0, (1,), 4, plan=PartialKernelPlan("rows", 64, 1, 8, 3),
              label="R of 7, rows"),
        _node((300, 9, 5), 130, 1, (0, 2), 2, label="R of 130"),
        WalkCase("ssd_intra", (1, 70, 33, 3, 6), 0, 4, label="ragged q and P"),
        WalkCase("ssd_intra", (2, 16, 32, 2, 64), 0, 2, label="one tile"),
        WalkCase("splitk_reduce", (3, 1000 * 64 + 5), 0, 4, label="n off the CTA"),
    ]
    # batches: 16 with shared and per-element factors, and 65,535
    for shared in (False, True):
        cases += [
            WalkCase("mttkrp3", (256, 256, 256), 32, 4, 16, shared=shared, label="batch"),
            WalkCase("mttkrpn", (64, 64, 64, 64), 16, 2, 8, shared=shared, label="batch"),
            WalkCase("multi_ttm_keep", (256, 256, 256), (16, 16), 4, 16, shared=shared,
                     label="batch"),
            _node((256, 256), 32, 1, (0,), 4, 16, label="batch"),
        ]
    cases += [
        WalkCase("mttkrp3", (8, 4, 4), 4, 4, 65535, label="batch 65535"),
        WalkCase("multi_ttm_keep", (1, 4, 4), (2, 2), 4, 65535, label="batch 65535"),
        _node((1, 8), 4, 0, (1,), 4, 65535, label="batch 65535"),
    ]
    return cases


def wrapper_launches() -> dict[str, int]:
    """Every Hopper wrapper's launch count (imports no kernel library)."""
    from ..kernels import mttkrp3, mttkrpn, multi_ttm, partial, splitk, ssd_intra, sweep

    fns = {"mttkrp3": mttkrp3.mttkrp3, "mttkrpn": mttkrpn.mttkrpn,
           "splitk_reduce": splitk.splitk_reduce, "fused_pair": sweep.fused_pair,
           "mttkrp_partial": partial.mttkrp_partial, "multi_ttm_keep": multi_ttm.multi_ttm_keep,
           "ssd_intra": ssd_intra.ssd_intra}
    return {name: fn.launches for name, fn in fns.items()}


def kernel_executed(analyzer: str, before: dict[str, int], subject: str) -> list[Finding]:
    """Rule ``kernel-executed``: no wrapper's launch count moved since
    ``before`` (:func:`wrapper_launches`)."""
    after = wrapper_launches()
    moved = {k: (before[k], after[k]) for k in after if after[k] != before[k]}
    if not moved:
        return []
    return [Finding(analyzer, "kernel-executed", subject,
                    f"wrapper launch counts moved during static analysis: {moved}")]


def check_case(case: WalkCase, sms: int = H100_SMS, walk: Walk | None = None
               ) -> tuple[list[Finding], dict]:
    """All rules on one case (its walk, or ``walk`` injected); the findings
    and the case's verdict."""
    plan = case_plan(case, sms)
    walk = walk if walk is not None else case_walk(case, plan, sms)
    smem = smem_bytes(case, plan)
    expect = _dtype(case.itemsize) if case.wrapper == "ssd_intra" else "float32"
    found, stats = check_walk(walk, f"{case} {plan!r}", expect_dtype=expect, smem=smem)
    verdict = {
        "analyzer": "kernels", "name": case.wrapper, "kernel": KERNEL_OF[case.wrapper],
        "label": case.label, "shape": list(case.shape),
        "rank": case.rank if isinstance(case.rank, int) else list(case.rank),
        "itemsize": case.itemsize, "batch": case.batch,
        "plan": None if plan is None else repr(plan), "grid": list(walk.grid),
        "splits": walk.grid[1], "buffers": [b.to_dict() for b in walk.buffers],
        "smem_bytes": smem, "writes_checked": stats["writes_checked"],
        "max_count": stats["max_count"], "agrees": not found, "findings": len(found),
    }
    return found, verdict


def verify_kernels(cases: Sequence[WalkCase] | None = None
                   ) -> tuple[list[Finding], list[dict]]:
    """Prove every case's walk (default :func:`kernel_cases`): one verdict a
    case, with its plan, grid, buffers, shared memory and the writes
    counted. No kernel runs (``kernel-executed``)."""
    before = wrapper_launches()
    findings: list[Finding] = []
    verdicts: list[dict] = []
    for case in cases if cases is not None else kernel_cases():
        found, verdict = check_case(case)
        findings += found
        verdicts.append(verdict)
    findings += kernel_executed("kernels", before, "verify_kernels")
    return findings, verdicts


# --------------------------------------------------------------------------
# The libraries' grids (on a host with the built libraries)
# --------------------------------------------------------------------------

def library_grid(case: WalkCase, plan=None, sms: int = H100_SMS) -> tuple[int, int, int]:
    """The launch grid the case's C launcher takes, from the library's own
    grid function (``repro_*_grid``, which the launcher calls): the split
    count the wrapper passes in is the mirror's. Builds the library if it
    is not built yet (a host with ``nvcc``)."""
    import ctypes

    from ..kernels.build import check, library

    plan = plan if plan is not None else case_plan(case, sms)
    dims = (ctypes.c_longlong * 3)()
    ll = ctypes.c_longlong
    w, shape = case.wrapper, case.shape
    if w in ("mttkrp3", "mttkrpn"):
        splits = mttkrp_kernel_grid(shape, case.rank, plan, sms, case.batch)[2]
        err = library("mttkrp.cu").repro_mttkrp_grid(shape[0], case.rank, plan.block_i,
                                                     plan.block_r, splits, case.batch, dims)
    elif w == "splitk_reduce":
        err = library("mttkrp.cu").repro_splitk_reduce_grid(shape[1], dims)
    elif w == "fused_pair":
        splits = pair_kernel_grid(shape, case.rank, plan, sms)[2]
        err = library("sweep.cu").repro_fused_pair_grid(shape[0], case.rank, plan.block_i,
                                                        plan.block_r, splits, dims)
    elif w == "mttkrp_partial":
        from ..engine.plan import PARTIAL_LAYOUTS

        keep, contract = shape[:case.nkeep], shape[case.nkeep:]
        err = library("sweep.cu").repro_partial_grid(
            case.itemsize, PARTIAL_LAYOUTS.index(plan.layout), plan.block_rows, plan.vec,
            plan.loads, plan.splits, len(keep), (ll * len(keep))(*keep), len(contract),
            (ll * len(contract))(*contract), case.rank, case.batch, dims)
    elif w == "multi_ttm_keep":
        k = len(case.rank)
        splits = multi_ttm_kernel_grid(shape, case.rank, plan, sms, case.batch)[2]
        err = library("multi_ttm.cu").repro_multi_ttm_grid(
            k, (ll * (k + 1))(*shape), (ctypes.c_int * k)(*case.rank), plan.block_m,
            plan.block_r, splits, case.batch, dims)
    elif w == "ssd_intra":
        bcn, q, _, h, _ = shape
        err = library("ssd_intra.cu").repro_ssd_intra_grid(bcn, q, h, plan.heads, plan.tile,
                                                           dims)
    else:
        raise ValueError(f"unknown wrapper {w!r}; expected one of {WRAPPERS}")
    check(err, f"{w} grid")
    return int(dims[0]), int(dims[1]), int(dims[2])
