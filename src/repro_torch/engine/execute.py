"""The dispatch layer: ``mttkrp``, ``contract_partial`` and ``multi_ttm``
over three backends, and the fused sweep's ``(B0, P)`` pair on ``cuda``.
Counterpart of ``repro.engine.execute.mttkrp`` / ``_mttkrp_impl``,
``contract_partial`` / ``_contract_partial_impl``, ``multi_ttm`` /
``_multi_ttm_impl`` and the pallas branch of
``repro.engine.sweep._fused_pair``.

``einsum``        — ``torch.einsum``.
``blocked_host``  — Algorithm 2's blocked schedule as a host-level einsum
                    (:mod:`repro_torch.core.blocked`), the kernels' oracle.
``cuda``          — the hand-written Hopper kernels
                    (:mod:`repro_torch.kernels.ops`), planned by
                    :mod:`repro_torch.engine.plan`.
``auto``          — resolved through the autotuner (:mod:`repro_torch.tune`):
                    a context pinned by ``ExecutionContext.for_problem``
                    replays its decision; else a tune-cache hit replays the
                    tuned backend and plan exactly, and a miss takes
                    ``cuda`` with the kernel's own plan on a CUDA tensor,
                    ``einsum`` on the host. ``tune=True`` searches on a
                    miss first (unbatched calls) and persists the winner.
                    A batched call resolves once, on the element's key.

Configuration comes in as one :class:`~.context.ExecutionContext`;
``plan``, ``block``, ``kernel_variant`` and ``out_dtype`` pin one
contraction's details. A leading batch axis on the tensor (B problems of one
shape, factors ``(B, I_k, R)`` per element or ``(I_k, R)`` shared) is one
batched call, as in the reference: one ``torch.einsum`` with a batch letter,
a host loop of the blocked schedule, or ONE kernel launch on ``cuda`` (the
batch is the kernels' grid z dimension), plus at most one
``splitk_reduce``. Each kernel wrapper counts its own launches
(``mttkrp3.launches``, ``mttkrpn.launches``, ``mttkrp_partial.launches``,
``fused_pair.launches``, ``multi_ttm_keep.launches``,
``splitk_reduce.launches``); the metrics registry counts the contractions
dispatched to them, once each (``engine.cuda_dispatches``).

Under an active :class:`repro_torch.observe.Trace` that admits the call
(:func:`repro_torch.observe.trace.should_record`) each entry point records
one span event, as the reference's do: the resolved backend, the plan its
kernel ran under (the tune cache's codec; the plan the card would launch on
a CPU tensor), the model plan's words (Eq 10, or
``MultiTTMPlan.model_words``) and the sequential lower bound against
``ctx.memory`` or ``Memory.h100_smem``, the dtype policy and the host's
time for the dispatch; on ``cuda`` also ``kernel_modeled_bytes``, the
kernel's own model of the bytes it moves under that plan
(``tune.search.kernel_plan_bytes``). With no trace, or one that refuses
the call, none of that work runs.
"""

from __future__ import annotations

import functools
import math
import time
from contextlib import contextmanager
from typing import Sequence

import torch

from ..core.blocked import mttkrp_blocked, multi_ttm_blocked
from ..core.bounds import multi_ttm_best_block_size, multi_ttm_seq_lb_memory, seq_lb_memory
from ..core.mttkrp import mttkrp as _einsum_mttkrp
from ..kernels import ops as kernel_ops
from ..kernels.ref import mttkrp_ref
from ..kernels.sweep import fused_pair_canonical
from ..observe import collect
from ..observe import trace as _otrace
from ..observe.metrics import CUDA_DISPATCHES, registry
from .context import ExecutionContext, torch_dtype
from .plan import (
    Memory,
    MTTKRPKernelPlan,
    MultiTTMKernelPlan,
    PartialKernelPlan,
    best_uniform_block,
    choose_blocks,
    choose_multi_ttm_blocks,
    keep_first,
)


def _count_cuda() -> None:
    # how many contractions were dispatched to the Hopper kernels (each
    # wrapper counts its own launches, splitk_reduce's included)
    registry().inc(CUDA_DISPATCHES)


# ---------------------------------------------------------------------------
# Span events (repro_torch.observe), recorded only when should_record admits
# ---------------------------------------------------------------------------

@contextmanager
def _observed(name: str, span: dict, *arrays):
    """One observed dispatch: a profiler range around it, the kernel
    launches it makes collected into ``span["launched"]`` and its host time
    into ``span["wall_time_us"]`` (no device synchronization)."""
    t0 = time.perf_counter()
    with _otrace.annotated(name, *arrays), collect.collecting() as launched:
        yield
    span["wall_time_us"] = (time.perf_counter() - t0) * 1e6
    span["launched"] = launched


def _span_plan(plan) -> dict | None:
    """A plan as a span records it: the tune cache's codec, tagged by type,
    so span plans and cached plans never drift apart."""
    return None if plan is None else dict(_plan_dict(plan))


@functools.lru_cache(maxsize=1024)
def _plan_dict(plan) -> dict:
    from ..tune.cache import plan_to_dict  # call-time: tune imports the engine

    return plan_to_dict(plan)


def _dtype_policy(ctx: ExecutionContext) -> dict:
    return {"compute_dtype": ctx.compute_dtype, "out_dtype": ctx.out_dtype}


def _span_memory(ctx: ExecutionContext, itemsize: int) -> Memory:
    """The memory a span's model and bound are taken against: the
    context's, else the Hopper kernels' shared memory (the tune key's
    default), where the reference takes ``Memory.tpu_vmem``."""
    return ctx.memory or Memory.h100_smem(itemsize=itemsize)


# The span's models are pure functions of the problem, and a span recurs on
# every iteration: memoized, so a traced dispatch does not re-plan in Python.

@functools.lru_cache(maxsize=1024)
def _kernel_bytes(plan, shape: tuple, rank, itemsize: int) -> int:
    from ..tune.search import kernel_plan_bytes  # call-time: tune imports the engine

    return int(kernel_plan_bytes(plan, shape, rank, itemsize))


@functools.lru_cache(maxsize=1024)
def _mttkrp_model(shape: tuple, mode_first: tuple, rank: int, itemsize: int, mem: Memory,
                  x_has_rank: bool) -> tuple[int, float]:
    """(Eq-10 words of the model plan, the Thm-4.1 bound clamped at 0)."""
    model = choose_blocks(mode_first, rank, itemsize, memory=mem, x_has_rank=x_has_rank)
    return (int(model.eq10_words(mode_first, rank)),
            max(seq_lb_memory(shape, rank, mem.budget_words), 0.0))


@functools.lru_cache(maxsize=1024)
def _multi_ttm_model(shape: tuple, canon: tuple, ranks: tuple, kernel_ranks: tuple,
                     itemsize: int, mem: Memory) -> tuple[int, float]:
    """(``MultiTTMPlan.model_words`` of the model plan, the HBL bound
    clamped at 0)."""
    model = choose_multi_ttm_blocks(canon, kernel_ranks, itemsize, memory=mem)
    return (int(model.model_words(canon)),
            max(multi_ttm_seq_lb_memory(shape, ranks, mem.budget_words), 0.0))


def _kernel_fields(span: dict, shape, rank, itemsize: int, batch: int = 1) -> tuple:
    """``(plan, extra)``: the plan the dispatch's first kernel ran under
    and, on ``cuda``, ``kernel_modeled_bytes`` (the kernel's model of the
    bytes it moves under that plan, for each element of a batch)."""
    plan = next((k.plan for k in span.get("launched", ()) if k.plan is not None), None)
    if span.get("backend") != "cuda" or plan is None:
        return plan, {}
    nbytes = _kernel_bytes(plan, tuple(shape), rank, itemsize) + span.get("other_written", 0)
    return plan, {"kernel_modeled_bytes": nbytes * batch}


def _record_mttkrp_span(kind: str, ctx, shape, rank, mode, itemsize, span, **extra) -> None:
    """One MTTKRP-shaped dispatch event: the resolved backend, the plan its
    kernel ran under, the Eq-10 words of the model plan against the span's
    memory, and the Thm-4.1 lower bound, clamped at 0."""
    mem = _span_memory(ctx, itemsize)
    shape = tuple(int(s) for s in shape)
    mode_first = keep_first(shape, mode) if kind == "mttkrp" else shape
    modeled, bound = _mttkrp_model(shape, mode_first, int(rank), itemsize, mem,
                                   bool(span.get("x_has_rank", False)))
    plan, kernel = _kernel_fields(span, mode_first, rank, span["kernel_itemsize"],
                                  extra.get("batch", 1))
    _otrace.record_event(
        kind,
        shape=list(shape),
        rank=int(rank),
        mode=int(mode),
        backend=span.get("backend"),
        plan=_span_plan(plan),
        modeled_words=modeled,
        lower_bound_words=bound,
        memory_words=mem.budget_words,
        itemsize=int(itemsize),
        wall_time_us=span["wall_time_us"],
        **_dtype_policy(ctx),
        **extra,
        **kernel,
    )


def _record_multi_ttm_span(ctx, shape, ranks, keep, itemsize, span, **extra) -> None:
    """One Multi-TTM dispatch event: the resolved backend, the plan its
    kernel ran under, the blocked model's words (``MultiTTMPlan.model_words``)
    and the HBL sequential lower bound, clamped at 0."""
    mem = _span_memory(ctx, itemsize)
    shape, ranks = tuple(int(s) for s in shape), tuple(int(r) for r in ranks)
    canon = keep_first(shape, 0 if keep is None else keep)
    kernel_ranks = ranks[1:] if keep is None else ranks
    modeled, bound = _multi_ttm_model(shape, canon, ranks, kernel_ranks, itemsize, mem)
    plan, kernel = _kernel_fields(span, canon, kernel_ranks, span["kernel_itemsize"],
                                  extra.get("batch", 1))
    _otrace.record_event(
        "multi_ttm",
        shape=list(shape),
        ranks=list(ranks),
        keep=keep,
        backend=span.get("backend"),
        plan=_span_plan(plan),
        modeled_words=modeled,
        lower_bound_words=bound,
        memory_words=mem.budget_words,
        itemsize=int(itemsize),
        wall_time_us=span["wall_time_us"],
        **_dtype_policy(ctx),
        **extra,
        **kernel,
    )


def _note_backend(span: dict | None, ctx: ExecutionContext, dtype: torch.dtype) -> None:
    """Record the resolved executor (and the width its operands run at)
    into an observed dispatch's span; count a ``cuda`` dispatch."""
    if ctx.backend == "cuda":
        _count_cuda()
    if span is not None:
        span["backend"] = ctx.backend
        span["kernel_itemsize"] = _compute_dtype(ctx, dtype).itemsize


def _compute_dtype(ctx: ExecutionContext, dtype: torch.dtype) -> torch.dtype:
    """The dtype a contraction runs in: the compute-dtype policy's, else
    the input's (the tune-cache key's dtype)."""
    return torch_dtype(ctx.compute_dtype) if ctx.compute_dtype is not None else dtype


def _cast(arrays, dtype):
    return [a.to(dtype) if a is not None else None for a in arrays]


def _auto_mttkrp(ctx, x, factors, mode, elem_shape, batched, plan, block, variant):
    """``backend="auto"`` for an MTTKRP: the pinned decision, else the tune
    cache (``kind="mttkrp"``, the mode-first element shape), after a search
    when ``ctx.tune`` (unbatched calls). Returns ``(ctx, plan, block,
    variant)`` on the resolved executor; explicit arguments win."""
    from ..tune import search  # call-time: tune imports the engine

    rank = next(int(f.shape[-1]) for k, f in enumerate(factors) if k != mode)
    dtype = _compute_dtype(ctx, x.dtype)
    decision = ctx.decision_for(elem_shape, rank, mode, dtype)
    if decision is None:
        if ctx.tune and not batched:
            search.tune_mttkrp(x.to(dtype), _cast(factors, dtype), mode, ctx=ctx)
        decision = search.resolve(keep_first(elem_shape, mode), rank, mode, dtype, ctx.memory,
                                  cache=ctx.plan_cache(), device=ctx.device)
    return (ctx.concrete(decision.backend), plan if plan is not None else decision.plan,
            block if block is not None else decision.block, variant or decision.variant)


def _auto_partial(ctx, node, factors, modes, drop, has_rank, elem_shape, batched, plan):
    """``backend="auto"`` for a dimension-tree edge (``kind="partial"``,
    the canonical element shape), after a search when ``ctx.tune``
    (unbatched calls). Returns ``(ctx, plan)``."""
    from ..tune import search  # call-time: tune imports the engine

    dtype = _compute_dtype(ctx, node.dtype)
    if ctx.tune and not batched:
        search.tune_partial(node.to(dtype), _cast(factors, dtype), modes, drop, has_rank,
                            ctx=ctx)
    r = search.resolve(search.partial_canon_shape(elem_shape, modes, drop),
                       int(factors[drop[0]].shape[-1]), 0, dtype, ctx.memory, kind="partial",
                       x_has_rank=has_rank, cache=ctx.plan_cache(), device=ctx.device)
    return ctx.concrete(r.backend), plan if plan is not None else r.plan


def _auto_multi_ttm(ctx, x, matrices, keep, elem_shape, batched, plan, block):
    """``backend="auto"`` for a Multi-TTM: the pinned decision (keyed by
    every Tucker rank, so a ``None`` kept matrix resolves live), else the
    tune cache (``kind="multi_ttm"``, kept mode first), after a search when
    ``ctx.tune`` (unbatched calls). Returns ``(ctx, plan, block)``."""
    from ..tune import search  # call-time: tune imports the engine

    dtype = _compute_dtype(ctx, x.dtype)
    keep_key = -1 if keep is None else keep
    decision = None
    if all(m is not None for m in matrices):
        decision = ctx.decision_for(elem_shape, tuple(int(m.shape[-1]) for m in matrices),
                                    keep_key, dtype)
    if decision is None:
        if ctx.tune and not batched:
            search.tune_multi_ttm(x.to(dtype), _cast(matrices, dtype), keep, ctx=ctx)
        ranks = tuple(int(m.shape[-1]) for k, m in enumerate(matrices) if k != keep)
        decision = search.resolve_multi_ttm(
            keep_first(elem_shape, max(keep_key, 0)), ranks, keep_key, dtype, ctx.memory,
            cache=ctx.plan_cache(), device=ctx.device)
    return (ctx.concrete(decision.backend), plan if plan is not None else decision.plan,
            block if block is not None else decision.block)


def _cast_compute(ctx: ExecutionContext, x, arrays, out_dtype):
    """The context's mixed-precision policy: cast the tensor and the factors
    to ``ctx.compute_dtype`` and default the output dtype to the ORIGINAL
    input dtype (bf16 streams, fp32 results). Accumulation stays fp32 on
    every backend. Returns ``(x, arrays, out_dtype, active)``."""
    if ctx.compute_dtype is None:
        return x, arrays, out_dtype, False
    cd = torch_dtype(ctx.compute_dtype)
    if out_dtype is None:
        out_dtype = x.dtype
    x = x.to(cd)
    arrays = [a.to(cd) if a is not None else None for a in arrays]
    return x, arrays, out_dtype, True


_L = "abcdefghijklmnopqrstuvw"
_RANK = "z"
_RANKS = "ABCDEFGHIJ"  # per-mode Tucker rank letters (Multi-TTM einsum)
_BATCH = "y"  # the batch axis of a batched call


def _batch_axes(api: str, arrays, batch: int, elem_dims, ranks, what: str) -> list[bool]:
    """Which per-mode operands of a batched call carry the batch: True for
    a per-element ``(B, I_k, R)`` stack, False for a shared ``(I_k, R)``
    operand (and for a ``None`` slot). ``ranks[k]`` may be ``None`` to skip
    the rank-extent check. Raises the reference's ``ValueError`` otherwise
    (``repro.engine.execute._batch_axes``)."""
    axes: list[bool] = []
    for k, a in enumerate(arrays):
        if a is None:
            axes.append(False)
            continue
        want = (elem_dims[k],) if ranks[k] is None else (elem_dims[k], ranks[k])
        if a.ndim == len(want) + 1 and tuple(a.shape) == (batch,) + want:
            axes.append(True)
        elif a.ndim == len(want) and tuple(a.shape) == want:
            axes.append(False)
        else:
            raise ValueError(
                f"{api}: batched call (B={batch}) needs {what} {k} of shape "
                f"{(batch,) + want} (per-element) or {want} (shared), got {tuple(a.shape)}"
            )
    return axes


def _operand(sub: str, per_element: bool) -> str:
    """An operand's einsum subscripts, the batch letter first if it has one."""
    return (_BATCH if per_element else "") + sub


def _stack_loop(fn, batch: int, x, arrays, axes) -> torch.Tensor:
    """``fn`` on each element of a batch (element b of every per-element
    operand, the shared ones as they are), stacked: the host-loop form."""
    return torch.stack([fn(x[b], [a[b] if per else a for a, per in zip(arrays, axes)])
                        for b in range(batch)])


def mttkrp(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor | None],
    mode: int,
    *,
    ctx: ExecutionContext | None = None,
    plan: MTTKRPKernelPlan | None = None,
    block: int | None = None,
    out_dtype: torch.dtype | None = None,
    kernel_variant: str | None = None,
) -> torch.Tensor:
    """MTTKRP through the engine: ``B^(mode)(i, r)``.

    ``ctx`` defaults to ``ExecutionContext.default()`` (the ``cuda`` backend on the
    card). ``plan`` pins block sizes for ``cuda``; ``block`` the uniform
    host-blocking size of ``blocked_host``; ``kernel_variant`` the 3-way
    specialized or N-way generic kernel."""
    ctx = ctx if ctx is not None else ExecutionContext.default()
    ctx.check_tensor("repro_torch.mttkrp", x, *factors)
    # a leading batch axis: B independent MTTKRPs in one call
    batched = x.ndim == len(factors) + 1
    if x.ndim != len(factors) and not batched:
        raise ValueError(f"{x.ndim}-way tensor with {len(factors)} factors")
    impl = _mttkrp_batched if batched else _mttkrp_impl
    args = (x, factors, mode, ctx, plan, block, out_dtype, kernel_variant)
    if not _otrace.should_record(ctx.observe, x, *factors):
        return impl(*args)
    span: dict = {}
    with _observed(f"repro_torch.mttkrp{'.batched' if batched else ''}.mode{mode}", span, x):
        out = impl(*args, _span=span)
    rank = next(int(f.shape[-1]) for k, f in enumerate(factors) if k != mode)
    extra = {"batch": int(x.shape[0])} if batched else {}
    _record_mttkrp_span("mttkrp", ctx, tuple(x.shape[int(batched):]), rank, mode,
                        x.element_size(), span, **extra)
    return out


def _mttkrp_impl(x, factors, mode, ctx, plan, block, out_dtype, kernel_variant, _span=None):
    if ctx.backend == "auto":
        ctx, plan, block, kernel_variant = _auto_mttkrp(
            ctx, x, factors, mode, tuple(x.shape), False, plan, block, kernel_variant)
    _note_backend(_span, ctx, x.dtype)
    memory = ctx.memory
    if out_dtype is None and ctx.out_dtype is not None:
        out_dtype = torch_dtype(ctx.out_dtype)
    x, factors, out_dtype, mixed = _cast_compute(ctx, x, factors, out_dtype)
    if ctx.backend == "einsum":
        # under a compute-dtype policy the float32 oracle accumulates in fp32
        out = mttkrp_ref(x, factors, mode) if mixed else _einsum_mttkrp(x, factors, mode)
        return out.to(out_dtype) if out_dtype is not None else out
    if ctx.backend == "blocked_host":
        if block is None:
            block = best_uniform_block(x.shape, memory or Memory.abstract(2 ** 20))
        out = mttkrp_blocked(x, factors, mode, block, f32_acc=mixed)
        return out.to(out_dtype) if out_dtype is not None else out
    # cuda: the kernel plans itself against its own shared memory
    # (choose_mttkrp_kernel_blocks); ctx.memory does not pick its plan. A
    # matrix runs the kernel too (one contraction axis); a 1-way tensor raises
    return kernel_ops.mttkrp(
        x, factors, mode, plan=plan, out_dtype=out_dtype, variant=kernel_variant
    )


def _mttkrp_batched(x, factors, mode, ctx, plan, block, out_dtype, kernel_variant,
                    _span=None):
    """B MTTKRPs as one call: ``x`` is ``(B, I_0, ..., I_{N-1})``,
    ``factors[k]`` is ``(B, I_k, R)`` (per element) or ``(I_k, R)``
    (shared). ``einsum`` takes one einsum with a batch letter,
    ``blocked_host`` loops the blocked schedule over the elements, ``cuda``
    launches the kernel once for the batch (its plan is the element's)."""
    batch, elem_shape = int(x.shape[0]), tuple(x.shape[1:])
    n = len(elem_shape)
    if not 0 <= mode < n:
        raise ValueError(f"mode {mode} out of range for batched {n}-way tensor")
    rank = next(int(f.shape[-1]) for k, f in enumerate(factors) if k != mode)
    axes = _batch_axes("repro_torch.mttkrp", factors, batch, elem_shape, [rank] * n, "factor")
    if ctx.backend == "auto":  # one resolution for the batch, on the element's key
        ctx, plan, block, kernel_variant = _auto_mttkrp(
            ctx, x, factors, mode, elem_shape, True, plan, block, kernel_variant)
    _note_backend(_span, ctx, x.dtype)
    if out_dtype is None and ctx.out_dtype is not None:
        out_dtype = torch_dtype(ctx.out_dtype)
    x, factors, out_dtype, mixed = _cast_compute(ctx, x, factors, out_dtype)
    if ctx.backend == "einsum":
        others = [k for k in range(n) if k != mode]
        subs = [_BATCH + _L[:n]] + [_operand(_L[k] + _RANK, axes[k]) for k in others]
        ops = [x] + [factors[k] for k in others]
        if mixed:  # fp32 accumulation under a compute-dtype policy
            ops = [o.float() for o in ops]
        out = torch.einsum(",".join(subs) + "->" + _BATCH + _L[mode] + _RANK, *ops)
        return out.to(out_dtype) if out_dtype is not None else out
    if ctx.backend == "blocked_host":
        if block is None:
            block = best_uniform_block(elem_shape, ctx.memory or Memory.abstract(2 ** 20))
        out = _stack_loop(lambda xb, fb: mttkrp_blocked(xb, fb, mode, block, f32_acc=mixed),
                          batch, x, factors, axes)
        return out.to(out_dtype) if out_dtype is not None else out
    # cuda: one launch for the batch, the element's plan
    return kernel_ops.mttkrp(x, factors, mode, plan=plan, out_dtype=out_dtype,
                             variant=kernel_variant, batched=True)


def contract_partial(
    node: torch.Tensor,
    factors: Sequence[torch.Tensor],
    modes: Sequence[int],
    drop: Sequence[int],
    has_rank: bool,
    *,
    ctx: ExecutionContext | None = None,
    plan: PartialKernelPlan | MTTKRPKernelPlan | None = None,
) -> torch.Tensor:
    """Contract the factors for ``drop`` out of a dimension-tree ``node``.

    ``node`` carries tensor modes ``modes`` (in axis order) plus a trailing
    rank axis when ``has_rank``; ``factors`` is the full factor list indexed
    by mode, read at call time. Returns the node for
    ``keep = modes - drop`` (rank axis last).

    ``einsum`` and ``blocked_host`` take one ``torch.einsum``. ``cuda``
    orders the node's axes kept modes first, dropped modes next, rank last:
    a node with a rank axis goes to the rank-augmented partial kernel as
    that permuted view, read in place (no copy); one without goes to the
    MTTKRP kernels as a canonical copy, kept modes flattened. ``plan`` pins
    the kernel's blocks: a ``PartialKernelPlan`` for the partial kernel, an
    ``MTTKRPKernelPlan`` for the MTTKRP kernels; a CPU tensor ignores it."""
    ctx = ctx if ctx is not None else ExecutionContext.default()
    ctx.check_tensor("repro_torch.contract_partial", node, *factors)
    modes, drop = tuple(modes), tuple(drop)
    batched = node.ndim == len(modes) + int(has_rank) + 1
    if node.ndim != len(modes) + int(has_rank) and not batched:
        raise ValueError(f"node of {node.ndim} axes for modes {modes} (has_rank={has_rank})")
    if not drop or any(m not in modes for m in drop):
        raise ValueError(f"drop {drop} must be a non-empty subset of modes {modes}")
    # a leading batch axis: B tree-node contractions in one call
    impl = _contract_partial_batched if batched else _contract_partial_impl
    args = (node, factors, modes, drop, has_rank, ctx, plan)
    if not _otrace.should_record(ctx.observe, node, *factors):
        return impl(*args)
    span: dict = {"x_has_rank": bool(has_rank)}
    with _observed(f"repro_torch.contract_partial{'.batched' if batched else ''}", span,
                   node):
        out = impl(*args, _span=span)
    from ..tune.search import partial_canon_shape  # call-time: tune imports the engine

    extra = {"batch": int(node.shape[0])} if batched else {}
    _record_mttkrp_span(
        "contract_partial", ctx, partial_canon_shape(node.shape[int(batched):], modes, drop),
        int(factors[drop[0]].shape[-1]), 0, node.element_size(), span,
        modes=list(modes), drop=list(drop), has_rank=bool(has_rank), **extra)
    return out


def _contract_partial_impl(node, factors, modes, drop, has_rank, ctx, plan, _span=None):
    if ctx.backend == "auto":
        ctx, plan = _auto_partial(ctx, node, factors, modes, drop, has_rank, tuple(node.shape),
                                  False, plan)
    _note_backend(_span, ctx, node.dtype)
    out_dtype = torch_dtype(ctx.out_dtype) if ctx.out_dtype is not None else None
    node, factors, out_dtype, mixed = _cast_compute(ctx, node, factors, out_dtype)
    keep = tuple(m for m in modes if m not in drop)
    if ctx.backend != "cuda":
        # Algorithm 2's host blocking exists for the full MTTKRP only, so
        # blocked_host partials are one einsum too, as in the reference
        sub_in = "".join(_L[m] for m in modes) + (_RANK if has_rank else "")
        subs = [sub_in] + [_L[m] + _RANK for m in drop]
        ops = [node] + [factors[m] for m in drop]
        if mixed:  # fp32 accumulation under a compute-dtype policy
            ops = [o.float() for o in ops]
        spec = ",".join(subs) + "->" + "".join(_L[m] for m in keep) + _RANK
        out = torch.einsum(spec, *ops)
        return out.to(out_dtype) if out_dtype is not None else out

    rank = factors[drop[0]].shape[1]
    pos = {m: i for i, m in enumerate(modes)}
    keep_sizes = tuple(node.shape[pos[m]] for m in keep)
    drop_sizes = tuple(node.shape[pos[m]] for m in drop)
    # kept modes first, dropped modes next, rank last
    perm = tuple(pos[m] for m in keep) + tuple(pos[m] for m in drop)
    fs = [factors[m] for m in drop]
    out_as = out_dtype if mixed else node.dtype
    if has_rank:
        # the partial kernel reads the permuted view in place, through its
        # strides, and plans itself (choose_partial_kernel_blocks); ctx.memory
        # does not pick its plan
        out = kernel_ops.mttkrp_partial_canonical(node.permute(perm + (node.ndim - 1,)), fs,
                                                  plan=plan, out_dtype=out_as)
    else:
        # the MTTKRP kernels take the canonical copy, kept modes flattened,
        # and plan themselves (choose_mttkrp_kernel_blocks)
        xp = node.permute(perm).reshape((math.prod(keep_sizes),) + drop_sizes)
        out = kernel_ops.mttkrp_canonical(xp, fs, plan=plan, out_dtype=out_as)
    out = out.reshape(keep_sizes + (rank,))
    return out.to(out_dtype) if out_dtype is not None else out


def _contract_partial_batched(node, factors, modes, drop, has_rank, ctx, plan, _span=None):
    """B dimension-tree contractions as one call: ``node`` carries a leading
    batch axis ahead of its tensor modes (and trailing rank axis when
    ``has_rank``); ``factors[m]`` for each dropped mode is ``(B, I_m, R)``
    or shared ``(I_m, R)``. ``einsum`` and ``blocked_host`` take one einsum
    with a batch letter; ``cuda`` one launch of the partial kernel (a node
    with a rank axis, read in place) or of the MTTKRP kernels (one without,
    as its canonical copy), the batch axis kept first."""
    keep = tuple(m for m in modes if m not in drop)
    batch, elem_shape = int(node.shape[0]), tuple(node.shape[1:])
    rank = int(factors[drop[0]].shape[-1])
    pos = {m: i for i, m in enumerate(modes)}
    # the factor list is indexed by mode; slots of modes the node lacks are
    # checked against their own rows, when present
    dims = [elem_shape[pos[k]] if k in pos else (None if f is None else int(f.shape[-2]))
            for k, f in enumerate(factors)]
    axes = _batch_axes("repro_torch.contract_partial", factors, batch, dims,
                       [rank] * len(factors), "factor")
    if ctx.backend == "auto":  # one resolution for the batch, on the element's key
        ctx, plan = _auto_partial(ctx, node, factors, modes, drop, has_rank, elem_shape, True,
                                  plan)
    _note_backend(_span, ctx, node.dtype)
    out_dtype = torch_dtype(ctx.out_dtype) if ctx.out_dtype is not None else None
    node, factors, out_dtype, mixed = _cast_compute(ctx, node, factors, out_dtype)
    if ctx.backend != "cuda":
        sub_in = _BATCH + "".join(_L[m] for m in modes) + (_RANK if has_rank else "")
        subs = [sub_in] + [_operand(_L[m] + _RANK, axes[m]) for m in drop]
        ops = [node] + [factors[m] for m in drop]
        if mixed:  # fp32 accumulation under a compute-dtype policy
            ops = [o.float() for o in ops]
        spec = ",".join(subs) + "->" + _BATCH + "".join(_L[m] for m in keep) + _RANK
        out = torch.einsum(spec, *ops)
        return out.to(out_dtype) if out_dtype is not None else out

    keep_sizes = tuple(elem_shape[pos[m]] for m in keep)
    drop_sizes = tuple(elem_shape[pos[m]] for m in drop)
    # the batch first, then kept modes, dropped modes, rank last
    perm = (0,) + tuple(1 + pos[m] for m in keep) + tuple(1 + pos[m] for m in drop)
    fs = [factors[m] for m in drop]
    out_as = out_dtype if mixed else node.dtype
    if has_rank:
        out = kernel_ops.mttkrp_partial_canonical(node.permute(perm + (node.ndim - 1,)), fs,
                                                  plan=plan, out_dtype=out_as, batched=True)
    else:
        xp = node.permute(perm).reshape((batch, math.prod(keep_sizes)) + drop_sizes)
        out = kernel_ops.mttkrp_canonical(xp, fs, plan=plan, out_dtype=out_as)
    out = out.reshape((batch,) + keep_sizes + (rank,))
    return out.to(out_dtype) if out_dtype is not None else out


def fused_pair(
    x: torch.Tensor, factors: Sequence[torch.Tensor], ctx: ExecutionContext,
    plan: MTTKRPKernelPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused sweep's opening ``(B0, P)`` pair in one launch of the
    fused pair kernel (the ``cuda`` backend): ``factors`` is the full
    factor list; both outputs come back in ``x``'s dtype, as the reference
    returns them. ``plan`` pins the kernel's blocks; else it plans itself
    against its own shared memory (``choose_pair_kernel_blocks``);
    ``ctx.memory`` does not pick its plan. One contraction dispatched to the
    kernels, and one ``fused_pair`` span under an admitting trace."""
    x, fs, out_dtype, _ = _cast_compute(ctx, x, list(factors[1:]), x.dtype)
    _count_cuda()
    if not _otrace.should_record(ctx.observe, x, *fs):
        return fused_pair_canonical(x, fs, plan=plan, out_dtype=out_dtype)
    rank = int(fs[0].shape[1])
    span: dict = {"backend": "cuda",
                  # the pair writes P beside the MTTKRP kernel's output
                  "other_written": math.prod(x.shape[:-1]) * rank * 4}
    with _observed("repro_torch.fused_pair", span, x):
        out = fused_pair_canonical(x, fs, plan=plan, out_dtype=out_dtype)
    launched_plan, kernel = _kernel_fields(span, tuple(x.shape), rank, x.element_size())
    _otrace.record_event(
        "fused_pair",
        shape=list(x.shape),
        rank=rank,
        backend="cuda",
        plan=_span_plan(launched_plan),
        itemsize=int(x.element_size()),
        wall_time_us=span["wall_time_us"],
        **_dtype_policy(ctx),
        **kernel,
    )
    return out


# ---------------------------------------------------------------------------
# Multi-TTM (the Tucker/HOSVD kernel, arXiv:2207.10437)
# ---------------------------------------------------------------------------

def _multi_ttm_einsum(x, matrices, keep, f32_acc=False):
    subs, ops, out = [_L[: x.ndim]], [x], ""
    for k in range(x.ndim):
        if k == keep:
            out += _L[k]
            continue
        ops.append(matrices[k])
        subs.append(_L[k] + _RANKS[k])
        out += _RANKS[k]
    if f32_acc:  # fp32 accumulation under a compute-dtype policy
        ops = [o.float() for o in ops]
    return torch.einsum(",".join(subs) + "->" + out, *ops)


def _looks_batched_multi_ttm(x, matrices, keep) -> bool:
    """The reference's test for ``multi_ttm(x_{N+1-way}, N matrices)``: a
    batched call only when every matrix fits the element problem ``x[b]``
    (``(B, I_k, R_k)``, ``(I_k, R_k)``, or ``None`` at the kept mode)."""
    batch, elem_shape = int(x.shape[0]), tuple(x.shape[1:])
    for k, m in enumerate(matrices):
        if m is None:
            if k != keep:
                return False
            continue
        rows = (elem_shape[k],)
        if not ((m.ndim == 3 and tuple(m.shape[:2]) == (batch,) + rows)
                or (m.ndim == 2 and tuple(m.shape[:1]) == rows)):
            return False
    return True


def multi_ttm(
    x: torch.Tensor,
    matrices: Sequence[torch.Tensor | None],
    keep: int | None = None,
    *,
    ctx: ExecutionContext | None = None,
    plan: MultiTTMKernelPlan | None = None,
    block: int | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Multi-TTM through the engine: contract every tensor mode (or every
    mode but ``keep``) with its matrix, the Tucker/HOSVD workhorse
    (arXiv:2207.10437).

    ``matrices[k]`` is ``(I_k, R_k)``; ``matrices[keep]`` is ignored (may be
    ``None``). ``keep=None`` computes the full core ``G = X x_1 A_1^T ...
    x_N A_N^T`` of shape ``(R_1, ..., R_N)``; ``keep=k`` computes the HOOI
    workhorse ``Y^(k) = X x_{j != k} A_j^T`` with the kept mode in place:
    ``(R_1, ..., I_k, ..., R_N)``.

    ``ctx`` (default ``ExecutionContext.default()``: the ``cuda`` backend on the
    card) selects ``einsum``, ``blocked_host`` (the uniform-b blocked
    schedule; ``block`` overrides the Eq-9 optimum) or ``cuda`` (the
    Hopper Multi-TTM kernel; ``plan``, a ``MultiTTMKernelPlan``, pins its
    blocks, else the kernel wrapper plans against the kernel's own shared
    memory with ``choose_multi_ttm_kernel_blocks``; ``ctx.memory`` is not
    used there, since ``choose_multi_ttm_blocks`` budgets for the Kronecker
    weight that the kernel never holds). The kernel needs a contracted mode
    beside the kept one, so ``cuda`` takes tensors of two or more modes. A
    leading batch axis, every matrix ``(B, I_k, R_k)`` or shared
    ``(I_k, R_k)``, is one batched call (one kernel launch on ``cuda``)."""
    ctx = ctx if ctx is not None else ExecutionContext.default()
    ctx.check_tensor("repro_torch.multi_ttm", x, *matrices)
    if x.ndim == len(matrices) + 1 and _looks_batched_multi_ttm(x, matrices, keep):
        # leading batch axis: B Multi-TTMs in one call
        return _observed_multi_ttm(_multi_ttm_batched, x, matrices, keep, ctx, plan, block,
                                   out_dtype, True)
    n = x.ndim
    if keep is not None and not 0 <= keep < n:
        raise ValueError(f"keep mode {keep} out of range for {n}-way tensor")
    if len(matrices) != n:
        raise ValueError(
            f"multi_ttm needs one matrix per tensor mode ({n}), got "
            f"{len(matrices)} (pass None at the kept mode)"
        )
    for k, m in enumerate(matrices):
        if k == keep:
            continue
        if m is None:
            raise ValueError(
                f"matrix {k} is None but mode {k} is contracted "
                f"(only matrices[keep] may be None; keep={keep})"
            )
        if m.shape[0] != x.shape[k]:
            raise ValueError(
                f"matrix {k} has {m.shape[0]} rows but tensor mode {k} "
                f"has extent {x.shape[k]}"
            )
    return _observed_multi_ttm(_multi_ttm_impl, x, matrices, keep, ctx, plan, block,
                               out_dtype, False)


def _observed_multi_ttm(impl, x, matrices, keep, ctx, plan, block, out_dtype, batched):
    """``impl`` (unbatched or batched), with its span under an admitting
    trace."""
    args = (x, matrices, keep, ctx, plan, block, out_dtype)
    concrete = [m for m in matrices if m is not None]
    if not _otrace.should_record(ctx.observe, x, *concrete):
        return impl(*args)
    span: dict = {}
    with _observed(f"repro_torch.multi_ttm{'.batched' if batched else ''}.keep{keep}", span,
                   x):
        out = impl(*args, _span=span)
    extra = {"batch": int(x.shape[0])} if batched else {}
    _record_multi_ttm_span(
        ctx, tuple(x.shape[int(batched):]),
        tuple(int(m.shape[-1]) for k, m in enumerate(matrices) if k != keep), keep,
        x.element_size(), span, **extra)
    return out


def _multi_ttm_impl(x, matrices, keep, ctx, plan, block, out_dtype, _span=None):
    if ctx.backend == "auto":
        ctx, plan, block = _auto_multi_ttm(ctx, x, matrices, keep, tuple(x.shape), False, plan,
                                           block)
    _note_backend(_span, ctx, x.dtype)
    n = x.ndim
    if out_dtype is None and ctx.out_dtype is not None:
        out_dtype = torch_dtype(ctx.out_dtype)
    x, matrices, out_dtype, mixed = _cast_compute(ctx, x, matrices, out_dtype)
    if ctx.backend == "einsum":
        out = _multi_ttm_einsum(x, matrices, keep, f32_acc=mixed)
        return out.to(out_dtype) if out_dtype is not None else out
    if ctx.backend == "blocked_host":
        if block is None:
            # the oracle's convention is kept-mode-first; for the full core
            # the lead mode plays the kept role (N-1 contracted ranks)
            ranks = tuple(m.shape[1] for k, m in enumerate(matrices) if k != keep)
            canon = keep_first(x.shape, 0 if keep is None else keep)
            mem = ctx.memory or Memory.abstract(2 ** 20)
            block = multi_ttm_best_block_size(
                canon, ranks[1:] if keep is None else ranks, mem.budget_words)
        out = multi_ttm_blocked(x, matrices, keep, block, f32_acc=mixed)
        return out.to(out_dtype) if out_dtype is not None else out
    # cuda: kept mode first (mode 0 for the full core), the kernel, then
    # the mode order restored
    if n < 2:
        raise ValueError(
            f"multi_ttm: the cuda backend needs a tensor of at least 2 modes (the kernel "
            f"contracts the modes beside the kept one), got {n}; use backend='einsum'"
        )
    lead = 0 if keep is None else keep
    perm = (lead,) + tuple(k for k in range(n) if k != lead)
    mats = [matrices[k] for k in perm[1:]]
    out2d = kernel_ops.multi_ttm_canonical(x.permute(perm), mats, plan=plan)
    rest_ranks = tuple(m.shape[1] for m in mats)
    if keep is None:
        # contract the lead mode too: one small matmul A_0^T @ Z
        out2d = matrices[0].to(out2d.dtype).T @ out2d
        out = out2d.reshape((matrices[0].shape[1],) + rest_ranks).to(x.dtype)
        return out.to(out_dtype) if out_dtype is not None else out
    out = out2d.reshape((x.shape[keep],) + rest_ranks)
    inv = [0] * n
    for pos, axis in enumerate(perm):
        inv[axis] = pos
    out = out.permute(inv).to(x.dtype)
    return out.to(out_dtype) if out_dtype is not None else out


def _multi_ttm_batched(x, matrices, keep, ctx, plan, block, out_dtype, _span=None):
    """B Multi-TTMs as one call: ``x`` is ``(B, I_1, ..., I_N)``,
    ``matrices[k]`` is ``(B, I_k, R_k)`` (per element), ``(I_k, R_k)``
    (shared), or ``None`` at the kept mode. ``einsum`` takes one einsum
    with a batch letter, ``blocked_host`` loops the blocked schedule over
    the elements, ``cuda`` launches the kernel once for the batch (kept
    mode first after the batch axis; the full core's lead-mode product one
    batched ``torch.matmul``)."""
    n = x.ndim - 1
    batch, elem_shape = int(x.shape[0]), tuple(x.shape[1:])
    if keep is not None and not 0 <= keep < n:
        raise ValueError(f"keep mode {keep} out of range for batched {n}-way tensor")
    for k, m in enumerate(matrices):
        if m is None and k != keep:
            raise ValueError(
                f"matrix {k} is None but mode {k} is contracted "
                f"(only matrices[keep] may be None; keep={keep})"
            )
    axes = _batch_axes("repro_torch.multi_ttm", matrices, batch, elem_shape,
                       [None if m is None else int(m.shape[-1]) for m in matrices], "matrix")
    if ctx.backend == "auto":  # one resolution for the batch, on the element's key
        ctx, plan, block = _auto_multi_ttm(ctx, x, matrices, keep, elem_shape, True, plan, block)
    _note_backend(_span, ctx, x.dtype)
    if out_dtype is None and ctx.out_dtype is not None:
        out_dtype = torch_dtype(ctx.out_dtype)
    x, matrices, out_dtype, mixed = _cast_compute(ctx, x, matrices, out_dtype)
    if ctx.backend == "einsum":
        subs, ops, out = [_BATCH + _L[:n]], [x], _BATCH
        for k in range(n):
            if k == keep:
                out += _L[k]
                continue
            ops.append(matrices[k])
            subs.append(_operand(_L[k] + _RANKS[k], axes[k]))
            out += _RANKS[k]
        if mixed:  # fp32 accumulation under a compute-dtype policy
            ops = [o.float() for o in ops]
        res = torch.einsum(",".join(subs) + "->" + out, *ops)
        return res.to(out_dtype) if out_dtype is not None else res
    if ctx.backend == "blocked_host":
        if block is None:
            ranks = tuple(m.shape[-1] for k, m in enumerate(matrices) if k != keep)
            canon = keep_first(elem_shape, 0 if keep is None else keep)
            mem = ctx.memory or Memory.abstract(2 ** 20)
            block = multi_ttm_best_block_size(
                canon, ranks[1:] if keep is None else ranks, mem.budget_words)
        res = _stack_loop(lambda xb, mb: multi_ttm_blocked(xb, mb, keep, block, f32_acc=mixed),
                          batch, x, matrices, axes)
        return res.to(out_dtype) if out_dtype is not None else res
    # cuda: the batch first, then the kept mode (mode 0 for the full core)
    if n < 2:
        raise ValueError(
            f"multi_ttm: the cuda backend needs a tensor of at least 2 modes (the kernel "
            f"contracts the modes beside the kept one), got {n}; use backend='einsum'"
        )
    lead = 0 if keep is None else keep
    perm = (lead,) + tuple(k for k in range(n) if k != lead)
    mats = [matrices[k] for k in perm[1:]]
    out3 = kernel_ops.multi_ttm_canonical(x.permute((0,) + tuple(1 + k for k in perm)), mats,
                                          plan=plan, batched=True)
    rest_ranks = tuple(m.shape[-1] for m in mats)
    if keep is None:
        # contract the lead mode too: one batched matmul A_0^T @ Z
        out3 = matrices[0].to(out3.dtype).transpose(-1, -2) @ out3
        res = out3.reshape((batch, matrices[0].shape[-1]) + rest_ranks).to(x.dtype)
        return res.to(out_dtype) if out_dtype is not None else res
    res = out3.reshape((batch, elem_shape[keep]) + rest_ranks)
    inv = [0] * n
    for p, axis in enumerate(perm):
        inv[axis] = p
    res = res.permute((0,) + tuple(1 + i for i in inv)).to(x.dtype)
    return res.to(out_dtype) if out_dtype is not None else res
