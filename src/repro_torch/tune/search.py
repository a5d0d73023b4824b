"""Empirical plan search, and the ``backend="auto"`` resolution it feeds.
Counterpart of ``repro.tune.search``.

Candidate space, for one contraction:

  * the executors ``einsum``, ``blocked_host`` (Algorithm 2's uniform-b
    blocking) and ``cuda`` (the Hopper kernels);
  * for ``cuda``, the kernel's own plans: the chooser's plan first
    (``choose_mttkrp_kernel_blocks``, ``choose_pair_kernel_blocks``,
    ``choose_multi_ttm_kernel_blocks``, ``choose_partial_kernel_blocks``),
    then its feasible neighbours, at most ``max_plans`` in all: for the
    MTTKRP and pair kernels ``block_i`` 64/128 x chunks of 64-256 bytes x
    2-4 stages (the grid ``scripts/probe_mttkrp.py`` and
    ``scripts/probe_ring.py`` walk), for Multi-TTM ``block_m`` 64/128/192 on
    the same chunks and stages, for the partial kernel layout x rows a
    thread x loads x split counts (``scripts/probe_partial.py``);
  * for 3-way tensors, both MTTKRP kernel variants (``mttkrp3`` and the
    generic ``mttkrpn``).

Each candidate runs through the same engine entry point production uses
and is checked against the einsum result first (``rtol`` 5e-3 of its
largest magnitude). A wrong candidate, or a plan the kernel refuses
(``ValueError``), is recorded as a loser; a kernel that fails to build or
launch raises, so a plain executor never wins in its place. Scoring:

  * ``metric="walltime"``: min of ``reps`` after ``warmup``, timed by CUDA
    events on a CUDA tensor (the host's clock on the CPU);
  * ``metric="traffic"``: kernel plans ranked by their modeled bytes
    (:func:`kernel_plan_bytes`) and only the best of them timed against
    the other executors. On CPU tensors the ``cuda`` candidates run the
    kernels' plain versions, whose time says nothing of the card's;
  * ``metric="auto"``: walltime on ``cuda``, traffic on the CPU.

:func:`resolve` (with :func:`resolve_multi_ttm` and :func:`resolve_sweep`)
is the ``backend="auto"`` entry: a cache hit returns the persisted winner
exactly, its kernel plan checked (``check()``) so a hand-edited cache never
hands a kernel a bad plan; a miss returns ``cuda`` with the kernel's own
plan on a CUDA device and ``einsum`` on the host.

The metrics registry (:mod:`repro_torch.observe.metrics`) counts each
resolution's hit or miss (``tune.cache_hits``, ``tune.cache_misses``) and
each candidate measured (``tune.candidates_measured``), and observes each
MTTKRP search's wall time (``tune.search_time_us``), which an admitting
trace also records as a ``tune_search`` span, as in the reference.
"""

from __future__ import annotations

import functools
import math
import time
from dataclasses import dataclass, field, replace
from typing import Sequence

import torch

from ..engine.context import CONCRETE_BACKENDS, ExecutionContext, dtype_name, torch_dtype
from ..engine.plan import (
    H100_SMS,
    MTTKRP_BLOCK_I,
    MULTI_TTM_BLOCK_M,
    SMEM_PER_CTA_MAX,
    Memory,
    MTTKRPKernelPlan,
    MultiTTMKernelPlan,
    PartialKernelPlan,
    choose_mttkrp_kernel_blocks,
    choose_multi_ttm_kernel_blocks,
    choose_pair_kernel_blocks,
    keep_first,
    mttkrp_kernel_grid,
    multi_ttm_kernel_grid,
    multi_ttm_kernel_smem_bytes,
    mttkrp_kernel_smem_bytes,
    n_splits,
    one_wave_splits,
    pair_kernel_smem_bytes,
    partial_kernel_grid,
    partial_kernel_smem_bytes,
    partial_kernel_threads,
    uniform_plan,
)
from ..observe import trace as _otrace
from ..observe.metrics import (
    TUNE_CACHE_HITS,
    TUNE_CACHE_MISSES,
    TUNE_CANDIDATES,
    TUNE_SEARCH_TIME_US,
    registry,
)
from .cache import CacheEntry, PlanCache, cache_key, default_cache, plan_to_dict

KERNEL_VARIANTS = ("specialized", "generic")
#: Chunk widths (bytes of an X row) and ring depths the tuner walks.
RING_CHUNK_BYTES = (64, 128, 256)
RING_STAGES = (2, 3, 4)


@dataclass(frozen=True)
class Candidate:
    """One runnable configuration of the engine for a fixed problem."""

    backend: str
    plan: object = None
    variant: str | None = None  # 3-way MTTKRP kernel variant, or the sweep schedule
    block: int | None = None  # blocked_host uniform block

    @property
    def label(self) -> str:
        if self.plan is not None:
            fields = "x".join(str(v) for v in self.plan.__dict__.values())
            v = f":{self.variant}" if self.variant else ""
            return f"{self.backend}{v}[{type(self.plan).__name__}:{fields}]"
        if self.backend == "blocked_host" and self.block is not None:
            return f"blocked_host[b={self.block}]"
        return self.backend + (f":{self.variant}" if self.variant else "")


@dataclass
class Measurement:
    candidate: Candidate
    walltime_us: float = float("nan")
    modeled_bytes: int | None = None
    score: float = float("inf")
    ok: bool = True
    error: str = ""


@dataclass
class TuneResult:
    key: str
    winner: Candidate
    measurements: list[Measurement] = field(default_factory=list)
    metric: str = "walltime"
    cache_hit: bool = False

    @property
    def best(self) -> Measurement:
        return next(m for m in self.measurements if m.candidate == self.winner)


def _itemsize(dtype) -> int:
    return dtype.itemsize if isinstance(dtype, torch.dtype) else torch_dtype(
        dtype_name(dtype)).itemsize


@functools.lru_cache(maxsize=8)
def _h100_smem(itemsize: int) -> Memory:
    return Memory.h100_smem(itemsize=itemsize)


def _memory(memory: Memory | None, itemsize: int) -> Memory:
    """The memory a key describes: the caller's, else one CTA's shared
    memory on the H100 (the kernels' fast memory)."""
    return memory if memory is not None else _h100_smem(itemsize)


# ---------------------------------------------------------------------------
# Candidate plans: the chooser's first, then its feasible neighbours
# ---------------------------------------------------------------------------

def _ring_neighbours(default, cls, smem, itemsize: int, row_blocks: Sequence[int],
                     max_plans: int) -> list:
    """``default`` and the ring kernels' plans around it: each row block x
    chunk width x ring depth at the default's ``block_r``, those the
    kernel takes within one CTA's shared memory (``smem(plan)``), nearest
    first (fewest fields changed), ``max_plans`` in all."""
    fields = list(default.__dict__.values())
    out = []
    for rows in row_blocks:
        for width in RING_CHUNK_BYTES:
            for stages in RING_STAGES:
                plan = cls(rows, width // itemsize, fields[2], stages)
                try:
                    if smem(plan) > SMEM_PER_CTA_MAX:
                        continue
                except ValueError:  # blocks the kernel does not take
                    continue
                if plan != default:
                    out.append(plan)
    out.sort(key=lambda p: sum(a != b for a, b in zip(p.__dict__.values(), fields)))
    return [default, *dict.fromkeys(out)][:max_plans]


def candidate_plans(shape: Sequence[int], rank: int, itemsize: int = 4, *,
                    kernel: str = "mttkrp", max_plans: int = 8) -> list[MTTKRPKernelPlan]:
    """The ``cuda`` plans of a canonical ``(I, C_1..C_k)`` problem for the
    MTTKRP kernel (``kernel="mttkrp"``) or the fused pair kernel
    (``"pair"``): the chooser's plan, then its neighbours."""
    nc = len(shape) - 1
    if kernel == "pair":
        default = choose_pair_kernel_blocks(shape, rank, itemsize)

        def smem(p):
            return pair_kernel_smem_bytes(p, itemsize, nc)
    else:
        default = choose_mttkrp_kernel_blocks(shape, rank, itemsize)

        def smem(p):
            return mttkrp_kernel_smem_bytes(p, itemsize, nc)
    return _ring_neighbours(default, MTTKRPKernelPlan, smem, itemsize, MTTKRP_BLOCK_I,
                            max_plans)


def multi_ttm_candidate_plans(canon: Sequence[int], kernel_ranks: Sequence[int],
                              itemsize: int = 4, *,
                              max_plans: int = 8) -> list[MultiTTMKernelPlan]:
    """The Multi-TTM kernel's plans for a kept-mode-first problem: the
    chooser's, then ``block_m`` 64/128/192 on the ring's chunks and
    stages."""
    ranks = tuple(int(r) for r in kernel_ranks)
    default = choose_multi_ttm_kernel_blocks(canon, ranks, itemsize)
    return _ring_neighbours(default, MultiTTMKernelPlan,
                            lambda p: multi_ttm_kernel_smem_bytes(p, itemsize, ranks),
                            itemsize, MULTI_TTM_BLOCK_M, max_plans)


def _partial_view(node: torch.Tensor, modes, drop) -> torch.Tensor:
    """A rank-carrying node as ``contract_partial`` hands it to the partial
    kernel: kept modes first, dropped modes next, rank last."""
    pos = {m: i for i, m in enumerate(modes)}
    keep = tuple(m for m in modes if m not in drop)
    return node.permute(tuple(pos[m] for m in keep + tuple(drop)) + (node.ndim - 1,))


def partial_candidate_plans(view: torch.Tensor, factors: Sequence[torch.Tensor], *,
                            max_plans: int = 8) -> list[PartialKernelPlan]:
    """The partial kernel's plans for a node ``view`` ``(K.., C.., R)`` and
    its dropped factors: the plan the wrapper chooses for the view, the
    same with the split counts of one and two full waves, then both layouts
    with 1, 2, 4 or 8 rows a thread and 4 or 8 loads, each with its splits
    by the default's rule."""
    from ..kernels import partial as partial_mod  # call-time: kernels import the engine

    rank = int(view.shape[-1])
    default = partial_mod.default_plan(view, factors)
    ksizes, _, csizes, _, *_ = partial_mod._kernel_view(view, factors)
    shape, nkeep = (*ksizes, *csizes), len(ksizes)
    sms = H100_SMS
    tl = partial_kernel_threads(rank, default.vec)[1]
    blocks, rtiles, units = partial_kernel_grid(shape, rank, default, nkeep)
    plans = [default]
    for splits in (n_splits(blocks * rtiles, units, sms), n_splits(blocks * rtiles, units,
                                                                   2 * sms)):
        plans.append(replace(default, splits=min(splits, 65535)))
    for layout in ("rows", "contract"):
        for rows in (1, 2, 4, 8):
            for loads in (4, 8):
                if loads < rows:
                    continue
                block = rows * (tl if layout == "rows" else 1)
                plan = PartialKernelPlan(layout, block, default.vec, loads, 1)
                try:
                    plan.check(rank, view.element_size())
                except ValueError:
                    continue
                b, rt, u = partial_kernel_grid(shape, rank, plan, nkeep)
                plans.append(replace(plan, splits=one_wave_splits(b * rt, u, sms)))
    plans = [p for p in dict.fromkeys(plans) if partial_kernel_smem_bytes(p, rank)
             <= SMEM_PER_CTA_MAX]
    return plans[:max_plans]


def generate_candidates(
    shape: Sequence[int],
    rank: int,
    memory: Memory,
    itemsize: int = 4,
    *,
    backends: Sequence[str] = ("einsum", "blocked_host", "cuda"),
    max_plans: int = 8,
) -> list[Candidate]:
    """Every executor, and for ``cuda`` every plan candidate of the MTTKRP
    kernel (:func:`candidate_plans`), for 3-way problems in both variants.
    ``shape`` is mode-first."""
    out: list[Candidate] = []
    n = len(shape)
    if "einsum" in backends:
        out.append(Candidate("einsum"))
    if "blocked_host" in backends:
        b = uniform_plan(shape, rank, Memory.abstract(memory.budget_words)).block_i
        out.append(Candidate("blocked_host", block=b))
    if "cuda" in backends and n >= 2:
        variants = KERNEL_VARIANTS if n == 3 else ("generic",)
        for plan in candidate_plans(shape, rank, itemsize, max_plans=max_plans):
            for variant in variants:
                out.append(Candidate("cuda", plan=plan, variant=variant))
    return out


# ---------------------------------------------------------------------------
# Modeled bytes of a kernel plan (the traffic metric)
# ---------------------------------------------------------------------------

def kernel_plan_bytes(plan, shape: Sequence[int], rank, itemsize: int = 4) -> int:
    """Bytes a kernel moves under ``plan`` on a canonical problem of
    ``shape`` (the node's axis sizes for the partial kernel, rank axis
    excluded), as its schedule reads them: the input once; the factor rows
    each CTA streams, once for each row tile (the MTTKRP and pair kernels:
    the last factor's rows a chunk and a row of each leading factor a
    leading tuple; Multi-TTM: the last matrix's rows a tile; the partial
    kernel: each dropped factor a row block); the fp32 output, once a
    split, and the reduction's read and write where there are splits. The
    model ranks plans under ``metric="traffic"``; the card decides the
    winner."""
    x_bytes = math.prod(shape) * itemsize
    if isinstance(plan, PartialKernelPlan):
        blocks, _, _ = partial_kernel_grid(tuple(shape), rank, plan)
        factor = blocks * sum(shape[1:]) * rank * itemsize
        out = shape[0] * rank * 4
        return x_bytes * rank + factor + out * plan.splits + (2 * out * plan.splits
                                                             if plan.splits > 1 else 0)
    if isinstance(plan, MultiTTMKernelPlan):
        ranks = tuple(rank)
        _, _, splits = multi_ttm_kernel_grid(shape, ranks, plan)
        rows = shape[-2] if len(shape) > 2 else shape[0]
        tiles = math.prod(shape[:-2]) * math.ceil(rows / plan.block_m) if len(shape) > 2 \
            else math.ceil(rows / plan.block_m)
        factor = tiles * shape[-1] * ranks[-1] * itemsize
        out = shape[0] * math.prod(ranks) * 4
    else:
        rows, _, splits = mttkrp_kernel_grid(shape, rank, plan)
        lead = math.prod(shape[1:-1])
        factor = rows * (lead * shape[-1] + lead * (len(shape) - 2)) * rank * itemsize
        out = shape[0] * rank * 4
    return x_bytes + factor + out * splits + (2 * out * splits if splits > 1 else 0)


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def _time_call(fn, warmup: int, reps: int, device: torch.device) -> float:
    """Min of ``reps`` times of ``fn`` in microseconds after ``warmup``
    calls: CUDA events on a CUDA device, the host's clock on the CPU."""
    for _ in range(max(0, warmup)):
        fn()
    best = float("inf")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(max(1, reps)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3)
        return best
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e6)
    return best


def _max_err(got, reference) -> tuple[float, float]:
    """(max |got - reference|, max |reference|) over every output."""
    got = got if isinstance(got, (list, tuple)) else [got]
    reference = reference if isinstance(reference, (list, tuple)) else [reference]
    err = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, reference))
    scale = max(float(r.float().abs().max()) for r in reference)
    return err, scale


def _measure_one(cand: Candidate, call, device: torch.device, *, reference=None,
                 rtol: float = 5e-3, warmup: int = 1, reps: int = 3,
                 modeled_bytes: int | None = None) -> Measurement:
    """Run, check against ``reference`` and time one candidate's ``call``.
    A wrong answer or a plan the kernel refuses (``ValueError``) is
    recorded as a loser; anything else (a kernel that fails to build or
    launch) is raised, so no plain executor wins in its place."""
    registry().inc(TUNE_CANDIDATES)
    m = Measurement(cand, modeled_bytes=modeled_bytes)
    try:
        got = call()
    except ValueError as e:
        m.ok = False
        m.error = f"{type(e).__name__}: {e}"
        return m
    if reference is not None:
        err, scale = _max_err(got, reference)
        if not math.isfinite(err) or err > rtol * (scale + 1e-30):
            m.ok = False
            m.error = f"maxerr={err:.3e} (scale {scale:.3e})"
            return m
    del got
    m.walltime_us = _time_call(call, warmup, reps, device)
    return m


def _resolve_metric(metric: str, device: torch.device) -> str:
    if metric == "auto":
        return "walltime" if device.type == "cuda" else "traffic"
    if metric not in ("walltime", "traffic"):
        raise ValueError(f"unknown metric {metric!r}")
    return metric


def _split_for_metric(cands: Sequence[Candidate], metric: str, tm_bytes):
    """Under the traffic metric, rank the ``cuda`` candidates by their
    modeled bytes and time only the best against the other executors;
    returns (timed, modeled only)."""
    if metric != "traffic":
        return list(cands), []
    kernel = sorted((c for c in cands if c.backend == "cuda"), key=tm_bytes)
    rest = [c for c in cands if c.backend != "cuda"]
    return rest + kernel[:1], kernel[1:]


def _assign_scores(measurements: list[Measurement], metric: str) -> None:
    """score = what the ranking used: modeled bytes for kernel plans under
    the traffic metric, wall time otherwise."""
    for m in measurements:
        if metric == "traffic" and m.candidate.backend == "cuda" \
                and m.modeled_bytes is not None:
            m.score = float(m.modeled_bytes)
        else:
            m.score = m.walltime_us


def _run_candidates(key, cands, metric, tm_bytes, call_for, reference, device, *,
                    rtol=5e-3, warmup=1, reps=3) -> tuple[Measurement, list[Measurement]]:
    """Measure ``cands`` (``call_for(c)`` is the candidate's call) under
    ``metric``; returns the winner's measurement and all of them."""
    timed, modeled_only = _split_for_metric(cands, metric, tm_bytes)
    measurements = [
        _measure_one(c, call_for(c), device, reference=reference, rtol=rtol, warmup=warmup,
                     reps=reps, modeled_bytes=tm_bytes(c) if c.plan is not None else None)
        for c in timed
    ]
    measurements += [Measurement(c, modeled_bytes=tm_bytes(c)) for c in modeled_only]
    ok = [m for m in measurements if m.ok and math.isfinite(m.walltime_us)]
    if not ok:
        raise RuntimeError(
            f"no candidate survived measurement for {key}: "
            + "; ".join(f"{m.candidate.label}: {m.error}" for m in measurements))
    _assign_scores(measurements, metric)
    return min(ok, key=lambda m: m.walltime_us), measurements


def _candidate_ctx(backend: str, device: torch.device) -> ExecutionContext:
    return ExecutionContext.create(backend, device=device.type)


def _defaults(ctx, memory, cache) -> tuple[Memory | None, PlanCache]:
    """``ctx`` supplies the memory and the cache handle (explicit arguments
    win)."""
    if ctx is not None:
        memory = memory if memory is not None else ctx.memory
        cache = cache if cache is not None else ctx.plan_cache()
    return memory, cache if cache is not None else default_cache()


def _hit(cache: PlanCache, key: str, force: bool) -> TuneResult | None:
    """The cached winner of ``key`` as a :class:`TuneResult`, or None."""
    entry = None if force else cache.get(key)
    if entry is None:
        return None
    winner = Candidate(entry.backend, plan=entry.to_plan(), variant=entry.variant,
                       block=entry.block)
    best = Measurement(winner, walltime_us=entry.walltime_us,
                       modeled_bytes=entry.modeled_bytes, score=entry.score)
    return TuneResult(key, winner, [best], entry.metric, cache_hit=True)


def _persist(cache: PlanCache, key: str, best: Measurement, metric: str, n: int,
             persist: bool, backend: str | None = None) -> None:
    c = best.candidate
    cache.put(key, CacheEntry(
        backend=backend or c.backend,
        plan=plan_to_dict(c.plan) if c.plan is not None else None,
        variant=c.variant, block=c.block, metric=metric, score=best.score,
        walltime_us=best.walltime_us, modeled_bytes=best.modeled_bytes,
        meta={"candidates": n}), persist=persist)


def _mttkrp_call(x, factors, mode, cand: Candidate):
    from ..engine import execute as engine_execute  # call-time: the engine imports tune

    cctx = _candidate_ctx(cand.backend, x.device)
    return lambda: engine_execute.mttkrp(x, factors, mode, ctx=cctx, plan=cand.plan,
                                         block=cand.block, kernel_variant=cand.variant)


def measure_candidate(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    cand: Candidate,
    *,
    warmup: int = 1,
    reps: int = 3,
    reference: torch.Tensor | None = None,
    rtol: float = 5e-3,
) -> Measurement:
    """Time one candidate through ``engine.execute.mttkrp`` and check it
    against ``reference`` (the einsum result)."""
    perm = keep_first(x.shape, mode)
    rank = next(int(f.shape[1]) for k, f in enumerate(factors) if k != mode)
    modeled = kernel_plan_bytes(cand.plan, perm, rank, x.element_size()) \
        if cand.plan is not None else None
    return _measure_one(cand, _mttkrp_call(x, factors, mode, cand), x.device,
                        reference=reference, rtol=rtol, warmup=warmup, reps=reps,
                        modeled_bytes=modeled)


def search(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    *,
    ctx: ExecutionContext | None = None,
    memory: Memory | None = None,
    metric: str = "auto",
    warmup: int = 1,
    reps: int = 3,
    max_plans: int = 8,
) -> TuneResult:
    """Measure the candidate space of one MTTKRP problem and return the
    winner, the fastest measured candidate (:func:`tune_mttkrp` persists
    it). ``ctx`` supplies ``memory`` (explicit arguments win). The search's
    wall time goes to ``tune.search_time_us``, and to a ``tune_search``
    span under an admitting trace."""
    from ..core.mttkrp import mttkrp as einsum_oracle

    t0 = time.perf_counter()
    if ctx is not None and memory is None:
        memory = ctx.memory
    metric = _resolve_metric(metric, x.device)
    perm = keep_first(x.shape, mode)
    rank = next(int(f.shape[1]) for k, f in enumerate(factors) if k != mode)
    itemsize = x.element_size()
    mem = _memory(memory, itemsize)
    key = cache_key(perm, rank, mode, x.dtype, mem, device=x.device)
    cands = generate_candidates(perm, rank, mem, itemsize, max_plans=max_plans)

    def tm_bytes(c):
        return kernel_plan_bytes(c.plan, perm, rank, itemsize)

    best, measurements = _run_candidates(
        key, cands, metric, tm_bytes, lambda c: _mttkrp_call(x, factors, mode, c),
        einsum_oracle(x, factors, mode), x.device, warmup=warmup, reps=reps)
    search_us = (time.perf_counter() - t0) * 1e6
    registry().observe(TUNE_SEARCH_TIME_US, search_us)
    if _otrace.should_record(ctx.observe if ctx is not None else False):
        _otrace.record_event(
            "tune_search", shape=list(perm), rank=int(rank), mode=int(mode), metric=metric,
            candidates=len(measurements),
            timed=len(_split_for_metric(cands, metric, tm_bytes)[0]),
            winner=best.candidate.label, search_time_us=search_us)
    return TuneResult(key, best.candidate, measurements, metric)


def tune_mttkrp(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    *,
    ctx: ExecutionContext | None = None,
    memory: Memory | None = None,
    cache: PlanCache | None = None,
    metric: str = "auto",
    force: bool = False,
    persist: bool = True,
    **search_kwargs,
) -> TuneResult:
    """Search (unless cached) and persist the winner under
    ``kind="mttkrp"``. Idempotent: a warm cache returns the stored entry,
    so a ``backend="auto", tune=True`` context searches once a problem."""
    memory, cache = _defaults(ctx, memory, cache)
    mem = _memory(memory, x.element_size())
    perm = keep_first(x.shape, mode)
    rank = next(int(f.shape[1]) for k, f in enumerate(factors) if k != mode)
    key = cache_key(perm, rank, mode, x.dtype, mem, device=x.device)
    hit = _hit(cache, key, force)
    if hit is not None:
        return hit
    result = search(x, factors, mode, ctx=ctx, memory=mem, metric=metric, **search_kwargs)
    _persist(cache, key, result.best, result.metric, len(result.measurements), persist)
    return result


# ---------------------------------------------------------------------------
# Partial contractions (dimension-tree edges, kind="partial")
# ---------------------------------------------------------------------------

def partial_canon_shape(shape, modes, drop) -> tuple[int, ...]:
    """A tree edge's canonical shape, the ``kind="partial"`` key's: the kept
    modes' extents multiplied, then the dropped modes' (rank axis apart)."""
    keep = tuple(m for m in modes if m not in drop)
    pos = {m: i for i, m in enumerate(modes)}
    return ((math.prod(shape[pos[m]] for m in keep) if keep else 1,)
            + tuple(shape[pos[m]] for m in drop))


def tune_partial(
    node: torch.Tensor,
    factors: Sequence[torch.Tensor],
    modes: Sequence[int],
    drop: Sequence[int],
    has_rank: bool,
    *,
    ctx: ExecutionContext | None = None,
    memory: Memory | None = None,
    cache: PlanCache | None = None,
    metric: str = "auto",
    force: bool = False,
    persist: bool = True,
    warmup: int = 1,
    reps: int = 3,
    max_plans: int = 8,
) -> TuneResult:
    """Search and persist the winner of one dimension-tree edge
    (``kind="partial"``: what ``contract_partial`` on ``auto`` resolves).
    Candidates: einsum, and ``cuda`` with the partial kernel's plans for a
    node with a rank axis (:func:`partial_candidate_plans`, from the view
    the engine hands it) or the MTTKRP kernel's for one without."""
    from ..engine import execute as engine_execute  # call-time: the engine imports tune

    memory, cache = _defaults(ctx, memory, cache)
    metric = _resolve_metric(metric, node.device)
    modes, drop = tuple(modes), tuple(drop)
    itemsize = node.element_size()
    mem = _memory(memory, itemsize)
    canon = partial_canon_shape(node.shape, modes, drop)
    rank = int(factors[drop[0]].shape[1])
    key = cache_key(canon, rank, 0, node.dtype, mem, kind="partial", device=node.device)
    hit = _hit(cache, key, force)
    if hit is not None:
        return hit
    if has_rank:
        view = _partial_view(node, modes, drop)
        fs = [factors[m].to(node.dtype).contiguous() for m in drop]
        plans = partial_candidate_plans(view, fs, max_plans=max_plans)
    else:
        plans = candidate_plans(canon, rank, itemsize, max_plans=max_plans) \
            if len(canon) >= 2 else []
    cands = [Candidate("einsum")] + [Candidate("cuda", plan=p) for p in plans]
    reference = engine_execute.contract_partial(
        node, factors, modes, drop, has_rank, ctx=_candidate_ctx("einsum", node.device))

    def call_for(c):
        cctx = _candidate_ctx(c.backend, node.device)
        return lambda: engine_execute.contract_partial(node, factors, modes, drop, has_rank,
                                                       ctx=cctx, plan=c.plan)

    best, measurements = _run_candidates(
        key, cands, metric, lambda c: kernel_plan_bytes(c.plan, canon, rank, itemsize),
        call_for, reference, node.device, warmup=warmup, reps=reps)
    _persist(cache, key, best, metric, len(measurements), persist)
    return TuneResult(key, best.candidate, measurements, metric)


# ---------------------------------------------------------------------------
# Multi-TTM (kind="multi_ttm"; engine.execute.multi_ttm)
# ---------------------------------------------------------------------------

def tune_multi_ttm(
    x: torch.Tensor,
    matrices: Sequence[torch.Tensor | None],
    keep: int | None,
    *,
    ctx: ExecutionContext | None = None,
    memory: Memory | None = None,
    cache: PlanCache | None = None,
    metric: str = "auto",
    force: bool = False,
    persist: bool = True,
    warmup: int = 1,
    reps: int = 3,
    max_plans: int = 8,
) -> TuneResult:
    """Search and persist the winner of one Multi-TTM problem
    (``kind="multi_ttm"``: what ``multi_ttm`` on ``auto`` resolves).
    Candidates: einsum, the uniform-b ``blocked_host`` schedule, and
    ``cuda`` with the Multi-TTM kernel's plans
    (:func:`multi_ttm_candidate_plans`)."""
    from ..core.bounds import multi_ttm_best_block_size
    from ..engine import execute as engine_execute  # call-time: the engine imports tune

    memory, cache = _defaults(ctx, memory, cache)
    metric = _resolve_metric(metric, x.device)
    itemsize = x.element_size()
    mem = _memory(memory, itemsize)
    keep_key = -1 if keep is None else keep
    canon = keep_first(x.shape, 0 if keep is None else keep)
    ranks = tuple(int(m.shape[1]) for k, m in enumerate(matrices) if k != keep)
    kernel_ranks = ranks[1:] if keep is None else ranks
    key = cache_key(canon, ranks, keep_key, x.dtype, mem, kind="multi_ttm", device=x.device)
    hit = _hit(cache, key, force)
    if hit is not None:
        return hit
    b = multi_ttm_best_block_size(canon, kernel_ranks,
                                  Memory.abstract(mem.budget_words).budget_words)
    cands = [Candidate("einsum"), Candidate("blocked_host", block=b)]
    if len(canon) >= 2:
        cands += [Candidate("cuda", plan=p) for p in multi_ttm_candidate_plans(
            canon, kernel_ranks, itemsize, max_plans=max_plans)]
    reference = engine_execute.multi_ttm(x, matrices, keep,
                                         ctx=_candidate_ctx("einsum", x.device))

    def call_for(c):
        cctx = _candidate_ctx(c.backend, x.device)
        return lambda: engine_execute.multi_ttm(x, matrices, keep, ctx=cctx, plan=c.plan,
                                                block=c.block)

    best, measurements = _run_candidates(
        key, cands, metric, lambda c: kernel_plan_bytes(c.plan, canon, kernel_ranks, itemsize),
        call_for, reference, x.device, warmup=warmup, reps=reps)
    _persist(cache, key, best, metric, len(measurements), persist)
    return TuneResult(key, best.candidate, measurements, metric)


# ---------------------------------------------------------------------------
# backend="auto" resolution (cache hit -> tuned; miss -> the kernel's own plan)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Resolved:
    """What ``backend="auto"`` decided for one problem."""

    backend: str
    plan: object
    variant: str | None
    block: int | None
    cache_hit: bool
    key: str


def _on_cuda(device) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return str(device).startswith("cuda")


@functools.lru_cache(maxsize=1024)
def _default_plan(kind: str, shape: tuple[int, ...], rank, itemsize: int):
    """The kernel's own plan on a miss (memoized: a miss recurs on every
    call of an untuned problem)."""
    if kind == "pair":
        return choose_pair_kernel_blocks(shape, rank, itemsize)
    if kind == "multi_ttm":
        return choose_multi_ttm_kernel_blocks(shape, rank, itemsize)
    return choose_mttkrp_kernel_blocks(shape, rank, itemsize)


def _checked(cache: PlanCache, memo: tuple) -> Resolved | None:
    """The hit ``memo`` (a resolver's own arguments) resolved to since the
    cache's last write (``PlanCache.checked``), counted as a hit; else None.
    The engine's ``auto`` branches resolve on every call, and a replayed
    hit neither rebuilds the key nor rebuilds and re-checks the plan."""
    done = cache.checked.get(memo)
    if done is not None:
        registry().inc(TUNE_CACHE_HITS)
    return done


def _lookup(cache: PlanCache, memo: tuple, key: str, itemsize: int, rank, *,
            concrete: bool = True, plan_type: type | None = None) -> Resolved | None:
    """The cached decision of ``key``, checked, or None on a miss. A hit
    whose backend is not an executor, or whose kernel plan the kernel does
    not take (``check()``), is refused with ``ValueError``, and a ``cuda``
    hit with a plan of another type (a reference ``BlockPlan``, say) with
    the ``TypeError`` the kernel wrappers give: a hand-edited cache never
    reaches a kernel with a bad plan. A hit that passes is kept under
    ``memo`` for :func:`_checked`; a refused one raises on every call."""
    entry = cache.get(key)
    registry().inc(TUNE_CACHE_HITS if entry is not None else TUNE_CACHE_MISSES)
    if entry is None:
        return None
    if concrete and entry.backend not in CONCRETE_BACKENDS:
        raise ValueError(f"tune cache entry {key!r}: backend {entry.backend!r} is not one of "
                         f"{CONCRETE_BACKENDS}")
    plan = entry.to_plan()
    if entry.backend == "cuda" and plan is not None and plan_type is not None \
            and not isinstance(plan, plan_type):
        # the wrappers' error for a plan of another type on a CUDA tensor
        raise TypeError(f"tune cache entry {key!r}: on a CUDA tensor the plan is a "
                        f"{plan_type.__name__}, got {type(plan).__name__}")
    try:
        if isinstance(plan, PartialKernelPlan):
            plan.check(int(rank), itemsize)
        elif isinstance(plan, (MTTKRPKernelPlan, MultiTTMKernelPlan)):
            plan.check(itemsize)
    except ValueError as e:
        raise ValueError(f"tune cache entry {key!r} refused: {e}") from None
    done = cache.checked[memo] = Resolved(entry.backend, plan, entry.variant, entry.block,
                                          True, key)
    return done


def resolve(
    shape: Sequence[int],
    rank: int,
    mode: int,
    dtype,
    memory: Memory | None = None,
    *,
    kind: str = "mttkrp",
    x_has_rank: bool = False,
    cache: PlanCache | None = None,
    device=None,
) -> Resolved:
    """Cache hit: the tuned configuration, exactly as persisted (its plan
    checked). Miss: ``cuda`` with the kernel's own plan on a CUDA
    ``device`` for 2-way problems and up (``choose_mttkrp_kernel_blocks``
    for ``kind="mttkrp"`` and the partial edges without a rank axis;
    ``choose_pair_kernel_blocks`` for ``kind="pair"``, the fused sweep's
    opening pair of a 3-way tensor and up; ``None`` for a rank-carrying
    partial edge, whose plan the kernel wrapper makes from the node's
    strides with ``choose_partial_kernel_blocks``), ``einsum`` on the
    host. ``shape`` is mode-first (the canonical shape of a partial edge,
    the tensor's for a pair)."""
    cache = cache if cache is not None else default_cache()
    memo = (kind, tuple(shape), rank, mode, dtype, memory, x_has_rank, device)
    hit = _checked(cache, memo)
    if hit is not None:
        return hit
    itemsize = _itemsize(dtype)
    key = cache_key(shape, rank, mode, dtype, _memory(memory, itemsize), kind=kind,
                    device=device)
    plan_type = PartialKernelPlan if kind == "partial" and x_has_rank else MTTKRPKernelPlan
    hit = _lookup(cache, memo, key, itemsize, rank, plan_type=plan_type)
    if hit is not None:
        return hit
    least = 3 if kind == "pair" else 2
    if _on_cuda(device) and len(shape) >= least:
        plan = None if kind == "partial" and x_has_rank else _default_plan(
            "pair" if kind == "pair" else "mttkrp", tuple(int(s) for s in shape), int(rank),
            itemsize)
        return Resolved("cuda", plan, None, None, False, key)
    return Resolved("einsum", None, None, None, False, key)


def resolve_multi_ttm(
    canon_shape: Sequence[int],
    ranks: Sequence[int],
    keep_key: int,
    dtype,
    memory: Memory | None = None,
    *,
    cache: PlanCache | None = None,
    device=None,
) -> Resolved:
    """``backend="auto"`` for one Multi-TTM problem (``kind="multi_ttm"``):
    hit, the tuned configuration exactly (its plan checked); miss, ``cuda``
    with ``choose_multi_ttm_kernel_blocks`` on a CUDA ``device`` for 2-way
    problems and up, ``einsum`` on the host. ``canon_shape`` is
    kept-mode-first, ``ranks`` every contracted rank, ``keep_key`` the kept
    mode or ``-1`` for the full core (whose kernel contracts the trailing
    modes, so its plan takes ``ranks[1:]``)."""
    cache = cache if cache is not None else default_cache()
    ranks = tuple(int(r) for r in ranks)
    memo = ("multi_ttm", tuple(canon_shape), ranks, keep_key, dtype, memory, device)
    hit = _checked(cache, memo)
    if hit is not None:
        return hit
    itemsize = _itemsize(dtype)
    key = cache_key(canon_shape, ranks, keep_key, dtype, _memory(memory, itemsize),
                    kind="multi_ttm", device=device)
    hit = _lookup(cache, memo, key, itemsize, ranks, plan_type=MultiTTMKernelPlan)
    if hit is not None:
        return hit
    if _on_cuda(device) and len(canon_shape) >= 2:
        kernel_ranks = ranks[1:] if keep_key == -1 else ranks
        plan = _default_plan("multi_ttm", tuple(int(s) for s in canon_shape), kernel_ranks,
                             itemsize)
        return Resolved("cuda", plan, None, None, False, key)
    return Resolved("einsum", None, None, None, False, key)


# ---------------------------------------------------------------------------
# The sweep schedule (kind="sweep"; cp_als sweep="auto")
# ---------------------------------------------------------------------------

def _sweep_pass_bytes(shape: Sequence[int], rank: int, itemsize: int, schedule: str) -> int:
    """Modeled streaming traffic of one ALS sweep's MTTKRP chain:
    ``per_mode`` reads the tensor once a mode; ``fused`` reads it twice
    and streams the rank-augmented partial P once to write it and once a
    middle mode and for B0 (arXiv:1708.08976)."""
    n = len(shape)
    x_words = math.prod(shape)
    if schedule == "per_mode":
        return n * x_words * itemsize
    p_words = math.prod(shape[:-1]) * rank
    return (2 * x_words + p_words * (n - 1)) * itemsize


def tune_sweep(
    x: torch.Tensor,
    rank: int,
    *,
    ctx: ExecutionContext | None = None,
    factors: Sequence[torch.Tensor] | None = None,
    memory: Memory | None = None,
    cache: PlanCache | None = None,
    metric: str = "auto",
    force: bool = False,
    persist: bool = True,
    warmup: int = 1,
    reps: int = 3,
    rtol: float = 5e-3,
    max_plans: int = 8,
) -> TuneResult:
    """Measure one ALS sweep's MTTKRP chain under the fused and the
    per-mode schedule and persist the winner (``kind="sweep"``: what
    ``cp_als(sweep="auto")`` resolves). With fixed factors every fused B
    equals the full MTTKRP, so the fused chain is checked against the
    per-mode chain. On a CUDA tensor whose context runs the kernels
    (``cuda`` or ``auto``) each plan of the fused pair kernel
    (:func:`candidate_plans` with ``kernel="pair"``) is a fused candidate
    of its own, and the fastest is also persisted as the ``kind="pair"``
    entry the pair resolves on ``auto``. ``metric="traffic"`` (the CPU's)
    ranks by :func:`_sweep_pass_bytes`. Idempotent like
    :func:`tune_mttkrp`."""
    from ..engine import execute as engine_execute  # call-time: the engine imports tune
    from ..engine.sweep import fused_als_sweep

    memory, cache = _defaults(ctx, memory, cache)
    metric = _resolve_metric(metric, x.device)
    itemsize = x.element_size()
    mem = _memory(memory, itemsize)
    key = cache_key(x.shape, rank, -1, x.dtype, mem, kind="sweep", device=x.device)
    hit = _hit(cache, key, force)
    if hit is not None:
        return hit
    if factors is None:
        gen = torch.Generator(device=x.device).manual_seed(0)
        factors = [torch.randn((s, rank), generator=gen, device=x.device, dtype=x.dtype)
                   for s in x.shape]
    factors = list(factors)
    measure_ctx = (ExecutionContext.create("auto", device=x.device.type) if ctx is None
                   else replace(ctx, tune=False, problem=None, decisions=()))
    n = x.ndim

    def per_mode_chain():
        return [engine_execute.mttkrp(x, factors, m, ctx=measure_ctx) for m in range(n)]

    def fused_chain(plan):
        def chain():
            out: list[torch.Tensor] = []

            def keep(mode, b):
                out.append(b)
                return factors[mode]

            fused_als_sweep(x, list(factors), keep, ctx=measure_ctx, pair_plan=plan)
            return out
        return chain

    backend_tag = measure_ctx.backend
    pair_plans: list = [None]
    if x.is_cuda and n >= 3 and backend_tag in ("cuda", "auto"):
        pair_plans = candidate_plans(tuple(x.shape), rank, itemsize, kernel="pair",
                                     max_plans=max_plans)
    cands = [(Candidate(backend_tag, variant="per_mode"), per_mode_chain)]
    cands += [(Candidate(backend_tag, plan=p, variant="fused"), fused_chain(p))
              for p in pair_plans]
    reference = per_mode_chain()
    measurements: list[Measurement] = []
    for cand, chain in cands:
        m = Measurement(cand, modeled_bytes=_sweep_pass_bytes(x.shape, rank, itemsize,
                                                              cand.variant))
        measurements.append(m)
        try:  # as _measure_one: only a refused plan or a wrong answer loses
            err, scale = _max_err(chain(), reference)
        except ValueError as e:
            m.ok, m.error = False, f"{type(e).__name__}: {e}"
            continue
        if not math.isfinite(err) or err > rtol * (scale + 1e-30):
            m.ok, m.error = False, f"maxerr={err:.3e} (scale {scale:.3e})"
        elif metric == "walltime":
            m.walltime_us = m.score = _time_call(chain, warmup, reps, x.device)
        else:
            m.score = float(m.modeled_bytes)
    ok = [m for m in measurements if m.ok and math.isfinite(m.score)]
    if not ok:
        raise RuntimeError(f"no sweep schedule survived measurement for {key}")
    best = min(ok, key=lambda m: m.score)
    _persist(cache, key, best, metric, len(measurements), persist)
    fused = [m for m in ok if m.candidate.variant == "fused" and m.candidate.plan is not None]
    if fused:
        pair = min(fused, key=lambda m: m.score)
        pair_key = cache_key(tuple(x.shape), rank, -1, x.dtype, mem, kind="pair",
                             device=x.device)
        _persist(cache, pair_key, replace(pair, candidate=replace(pair.candidate,
                                                                  variant=None)),
                 metric, len(fused), persist, backend="cuda")
    return TuneResult(key, best.candidate, measurements, metric)


def resolve_sweep(
    shape: Sequence[int],
    rank: int,
    dtype,
    memory: Memory | None = None,
    *,
    cache: PlanCache | None = None,
    device=None,
) -> Resolved:
    """``sweep="auto"``: hit, the tuned schedule (``variant`` ``"fused"`` or
    ``"per_mode"``, with the fused pair kernel's plan where one was tuned);
    miss, ``"fused"`` for 3-way tensors and up (two tensor passes beat N),
    ``"per_mode"`` below."""
    cache = cache if cache is not None else default_cache()
    memo = ("sweep", tuple(shape), rank, dtype, memory, device)
    hit = _checked(cache, memo)
    if hit is not None:
        return hit
    itemsize = _itemsize(dtype)
    key = cache_key(shape, rank, -1, dtype, _memory(memory, itemsize), kind="sweep",
                    device=device)
    hit = _lookup(cache, memo, key, itemsize, rank, concrete=False,
                  plan_type=MTTKRPKernelPlan)
    if hit is not None:
        return hit
    return Resolved("auto", None, "fused" if len(shape) >= 3 else "per_mode", None, False, key)
