"""Distributed Multi-TTM and the Tucker/HOOI sweep driver on
``torch.distributed``. Counterpart of ``repro.distributed.tucker_parallel``.

The Multi-TTM story (arXiv:2207.10437) parallelizes on the same
stationary-tensor distribution as Algorithm 3: X is block-distributed over
the N-way grid and never moves. Two programs live here, each SPMD as in
:mod:`.cp_als_parallel` (every rank calls with its own blocks, cut by
:func:`~.mttkrp_parallel.tensor_block`):

* :func:`multi_ttm_stationary` — one full-core Multi-TTM: matrices in the
  CP factor layout (block-rows spread over the mode hyperslices), gathered
  exactly like Alg 3's factors, then the local partial core is all-reduced
  over the grid. Per-rank volume
  :func:`repro_torch.core.bounds.par_multi_ttm_cost`.

* :func:`build_tucker_sweep` — one HOOI sweep. Factor matrices are carried
  *replicated* (they are tall-skinny ``I_k x R_k``): each rank slices its
  own block-rows, runs the local Multi-TTM through the engine (on
  ``backend="cuda"`` one ``multi_ttm_keep`` launch a mode), all-reduces the
  partial ``Y^(k)`` block-rows over the mode-k hyperslice, all-gathers them
  over the mode-k fiber, and updates ``A_k`` by an eigendecomposition of
  the same Gram on every rank, after which every rank again holds all of
  ``A_k``: factors never travel in a collective. Per-sweep volume
  :func:`~.grid_select.multi_ttm_sweep_words`.

Every rank's ``eigh`` sees the same bytes (the all-reduce hands every rank
of a hyperslice the same sum, the all-gather the same rows in the fiber's
order), so the factors stay equal across ranks without a broadcast.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Callable, Sequence

import torch

from ..core.tensor import frob_norm
from ..core.tucker import TuckerResult, _check_ranks, _leading_eigvecs, _unfold_rows, hosvd_init
from ..observe import trace as _otrace
from . import collectives
from .grid_select import choose_tucker_grid, multi_ttm_sweep_words
from .mesh import GridMesh, make_grid_mesh, mode_axis, validate_tucker_grid, world_size
from .mttkrp_parallel import factor_block, gather_factors, tensor_block
from .ring import ring_all_gather

#: ``f(x_loc, matrices, keep) -> Y`` (``keep=None``: the core).
MultiTTMFn = Callable[[torch.Tensor, Sequence[torch.Tensor | None], int | None], torch.Tensor]


def _engine_multi_ttm(ctx=None) -> MultiTTMFn:
    """This rank's Multi-TTM through the engine, under ``ctx.local()`` (the
    separation of :func:`~.mttkrp_parallel.engine_local_fn`: the programs
    here own the collectives; inside each block the problem is the
    sequential one, on ``backend="cuda"`` the Hopper Multi-TTM kernel)."""
    from ..engine import execute as engine_execute  # call-time: layer cycle
    from ..engine.context import ExecutionContext

    if ctx is None:
        ctx = ExecutionContext.default()
    local_ctx = ctx.local()

    def fn(x_loc, mats, keep):
        return engine_execute.multi_ttm(x_loc, mats, keep, ctx=local_ctx)

    return fn


# --------------------------------------------------------------------------
# One full-core Multi-TTM (matrices in the Alg-3 factor layout)
# --------------------------------------------------------------------------

def multi_ttm_stationary(mesh: GridMesh, ndim: int, *, ctx=None,
                         local_fn: MultiTTMFn | None = None):
    """The stationary-tensor full-core Multi-TTM as ``f(x_loc, *m_locs) ->
    core`` on this rank's blocks (:func:`place_multi_ttm_inputs`), the
    core the same on every rank. Every matrix's block-rows are gathered
    over its mode hyperslice (Alg 3 line 4), the core contracted locally,
    and the partial core all-reduced over the grid:
    ``par_multi_ttm_cost`` words a rank. The local Multi-TTM goes through
    the engine under ``ctx``; an explicit ``local_fn`` overrides it."""
    if mesh.p0 != 1:
        raise ValueError("multi_ttm_stationary keeps X stationary; pass a p0=1 grid mesh")
    if mesh.ndim != ndim:
        raise ValueError(f"grid {mesh.grid} is not {ndim}-way")
    if local_fn is None:
        local_fn = _engine_multi_ttm(ctx)

    def fn(x_loc, *m_locs):
        gathered = gather_factors(list(m_locs), mesh)
        core_part = local_fn(x_loc, gathered, None)
        return collectives.all_reduce(core_part, mesh.grid_group())

    return fn


def place_multi_ttm_inputs(mesh: GridMesh, x: torch.Tensor, matrices: Sequence[torch.Tensor]):
    """This rank's block of X and of every matrix (the CP factor layout),
    on the rank's device: ``(x_loc, m_locs)``."""
    xs = tensor_block(x, mesh)
    ms = tuple(factor_block(m, mesh, k) for k, m in enumerate(matrices))
    return xs, ms


# --------------------------------------------------------------------------
# The HOOI sweep
# --------------------------------------------------------------------------

def _local_rows(f_full: torch.Tensor, mesh: GridMesh, j: int) -> torch.Tensor:
    """This rank's block-rows of the replicated factor j (a view)."""
    rows = f_full.shape[0] // mesh.grid[j]
    return f_full.narrow(0, mesh.coord(mode_axis(j)) * rows, rows)


def _tucker_sweep_local(x_loc, factors, normx, *, mesh: GridMesh, ranks: tuple[int, ...],
                        local_fn: MultiTTMFn, compute_fit: bool, overlap: str = "none"):
    """One full HOOI sweep (all N mode updates) on this rank's block; the
    factors are replicated, X stays put, and the only collectives are one
    hyperslice all-reduce and one fiber all-gather of the partial Y^(k) a
    mode (:func:`multi_ttm_sweep_words`).

    ``overlap="ring"`` spells the fiber all-gather as a ring
    (:func:`~.ring.ring_all_gather`): the same rows, the same ring bytes,
    as ``P_k - 1`` hops."""
    ndim = mesh.ndim
    factors = list(factors)
    dtype = x_loc.dtype
    zm = None
    for k in range(ndim):
        mats = [None if j == k else _local_rows(factors[j], mesh, j) for j in range(ndim)]
        z_part = local_fn(x_loc, mats, k)
        z_rows = collectives.all_reduce(z_part, mesh.hyperslice(k))
        zm_rows = _unfold_rows(z_rows, k)
        fiber = mesh.fiber(k)
        zm = ring_all_gather(zm_rows, fiber) if overlap == "ring" \
            else collectives.all_gather(zm_rows, fiber)
        factors[k] = _leading_eigvecs(zm @ zm.T, ranks[k]).to(dtype)
    # the core falls out of the last mode update (mode N-1 rows of zm):
    # (R_{N-1}, prod_{j<N-1} R_j) -> (R_0, ..., R_{N-1})
    core_mat = factors[ndim - 1].T.float() @ zm.float()
    core = core_mat.reshape((ranks[ndim - 1],) + ranks[:ndim - 1]).movedim(0, ndim - 1).to(dtype)
    if compute_fit:
        err_sq = torch.clamp(normx ** 2 - frob_norm(core) ** 2, min=0.0)
        fit = 1.0 - torch.sqrt(err_sq) / torch.clamp(normx, min=1e-30)
    else:
        fit = torch.zeros((), dtype=dtype, device=x_loc.device)
    return tuple(factors), core, fit


def build_tucker_sweep(mesh: GridMesh, ndim: int, ranks: Sequence[int], *, ctx=None,
                       compute_fit: bool = True) -> Callable:
    """The sweep ``f(x_loc, factors, normx) -> (factors, core, fit)`` on
    this rank's block of X (:func:`place_tucker_state`) and the replicated
    factors; ``ctx.distribution.overlap`` picks the fiber all-gather
    (``"none"`` or ``"ring"``)."""
    if mesh.p0 != 1:
        raise ValueError("tucker_hooi_parallel keeps X stationary; pass a p0=1 grid mesh")
    if mesh.ndim != ndim:
        raise ValueError(f"grid {mesh.grid} is not {ndim}-way")
    ranks = tuple(int(r) for r in ranks)
    local_fn = _engine_multi_ttm(ctx)
    overlap = ctx.distribution.overlap if ctx is not None and ctx.distribution is not None \
        else "none"

    def sweep(x_loc, factors, normx):
        return _tucker_sweep_local(x_loc, factors, normx, mesh=mesh, ranks=ranks,
                                   local_fn=local_fn, compute_fit=compute_fit, overlap=overlap)

    return sweep


def place_tucker_state(mesh: GridMesh, x: torch.Tensor, factors: Sequence[torch.Tensor]):
    """The sweep's carried state on this rank's device: X's block (it never
    moves again) and the factors, replicated."""
    return tensor_block(x, mesh), tuple(f.to(mesh.device) for f in factors)


# --------------------------------------------------------------------------
# The driver
# --------------------------------------------------------------------------

def tucker_hooi_parallel(
    x: torch.Tensor,
    ranks: Sequence[int],
    n_iters: int = 10,
    *,
    ctx=None,
    init_factors: Sequence[torch.Tensor] | None = None,
    grid: Sequence[int] | None = None,
    mesh: GridMesh | None = None,
    procs: int | None = None,
    tol: float = 0.0,
    compute_fit: bool = True,
) -> TuckerResult:
    """Distributed Tucker/HOOI over the initialized default group, with
    automatic grid selection.

    Every rank calls it with the whole tensor ``x`` (and the same
    ``init_factors``, if any). The grid: an explicit ``mesh`` wins; else an
    explicit ``grid`` (the argument, then ``ctx.distribution.grid``) is
    validated against the extents; else
    :func:`~.grid_select.choose_tucker_grid` picks the Multi-TTM-sweep
    optimal evenly-sharding grid for ``procs`` (default: the world size).
    Initialization is HOSVD of the whole tensor on every rank, and ``||X||``
    is the whole tensor's, so a sweep's collectives are the model's and
    nothing else. ``n_iters < 1`` runs the sequential driver under
    ``ctx.local()``. Factors come back orthonormal and the core replicated,
    the same on every rank, as :func:`repro_torch.tucker_hooi` returns
    them."""
    from ..engine.context import Distribution, ExecutionContext

    if ctx is None:
        ctx = ExecutionContext.default()
    if ctx.distribution is None:
        # this driver IS the distributed path: a plain context means
        # "select everything automatically"
        ctx = replace(ctx, distribution=Distribution())
    if ctx.distribution.p0 != 1:
        raise ValueError(
            "the Tucker sweep keeps X stationary on an N-way grid; "
            "rank-axis (p0>1) contexts are for single-mode mttkrp_general"
        )
    ctx.check_tensor("repro_torch.tucker_hooi_parallel", x, *(init_factors or ()))
    ndim = x.ndim
    ranks = _check_ranks(x.shape, ranks)
    dist_cfg = ctx.distribution
    mesh = mesh if mesh is not None else dist_cfg.mesh
    grid = tuple(grid) if grid is not None else dist_cfg.grid
    procs = procs if procs is not None else dist_cfg.procs
    if mesh is None:
        if grid is None:
            procs = procs if procs is not None else world_size("tucker_hooi_parallel")
            grid = choose_tucker_grid(x.shape, ranks, procs).grid
        validate_tucker_grid(grid, dims=x.shape)
        mesh = make_grid_mesh(grid, device=ctx.device)
    else:
        if mesh.p0 != 1:
            raise ValueError("tucker_hooi_parallel keeps X stationary; pass a p0=1 grid mesh")
        grid = mesh.grid
        validate_tucker_grid(grid, dims=x.shape)
    if len(grid) != ndim:
        raise ValueError(f"grid {grid} is not {ndim}-way")

    if init_factors is not None:
        factors = [f.to(x.dtype) for f in init_factors]
    else:
        factors = hosvd_init(x, ranks)
    if n_iters < 1:  # HOSVD only: no sweep to run
        from ..core.tucker import tucker_hooi

        return tucker_hooi(x, ranks, 0, ctx=ctx.local(), init_factors=factors)
    normx = frob_norm(x).to(mesh.device)

    fit_on = compute_fit or tol > 0
    sweep = build_tucker_sweep(mesh, ndim, ranks, ctx=ctx, compute_fit=fit_on)
    xs, fs = place_tucker_state(mesh, x, factors)

    observe = _otrace.should_record(ctx.observe)
    fits: list[float] = []
    first = None
    core = None
    for it in range(n_iters):
        before = collectives.COUNTER.snapshot()
        fs, core, fit = sweep(xs, fs, normx)
        if fit_on:
            fits.append(float(fit))
        if observe:
            by_kind = collectives.COUNTER.delta(before)
            first = first or by_kind
            from ..observe.metrics import SWEEP_COLLECTIVE_BYTES, registry

            registry().observe(SWEEP_COLLECTIVE_BYTES, float(collectives.ring_total(by_kind)))
        if tol and it > 0 and abs(fits[-1] - fits[-2]) < tol:
            break
    if observe and first is not None:
        itemsize = x.element_size()
        modeled = int(multi_ttm_sweep_words(x.shape, ranks, grid))
        _otrace.record_event(
            "tucker_sweep_collectives",
            shape=list(x.shape),
            ranks=list(ranks),
            grid=list(grid),
            procs=int(math.prod(grid)),
            itemsize=itemsize,
            measured_collective_bytes=int(collectives.ring_total(first)),
            modeled_words=modeled,
            modeled_bytes=modeled * itemsize,
            collectives_by_kind=first,
            transport=mesh.backend,
            overlap=dist_cfg.overlap,
            measured_by="collective_wrappers",
        )
    return TuckerResult(core, list(fs), fits)
