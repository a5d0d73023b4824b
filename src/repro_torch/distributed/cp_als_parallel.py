"""Distributed CP-ALS: the stationary-tensor sweep driver. Counterpart of
``repro.distributed.cp_als_parallel``.

X stays in the Alg-3 block distribution for the whole decomposition, and
factor communication amortizes across the N mode updates
(Ballard-Hayashi-Kannan, arXiv:1806.07985):

* X is block-distributed over the N-way grid and never moves.
* Each factor's gathered block-rows (Alg 3's ``S^{(k)}_{p_k}``) are carried
  state: produced by the all-gather right after that factor's update and
  reused by every later mode update of this sweep and the next. So a sweep
  all-gathers each factor once and reduce-scatters each MTTKRP output once.
* The normal equations are solved on the row blocks: Γ_n is the Hadamard
  product of carried R×R Grams (replicated), each rank solves its own rows,
  and the updated Gram is rebuilt from the gathered block-rows with one R×R
  all-reduce over the P_n ranks of the mode-n fiber. λ comes from the
  Gram's diagonal, with no collective of its own.
* The local MTTKRP goes through :func:`~.mttkrp_parallel.engine_local_fn`,
  so on ``backend="cuda"`` every rank launches the ``mttkrp3``/``mttkrpn``
  kernels on its block.

The program is SPMD (``docs/PORT.md``): every rank calls
:func:`cp_als_parallel` with the whole tensor, cuts its own block, and
returns the same gathered :class:`~repro_torch.core.cp_als.CPResult`. The
arithmetic is the reference's (``_sweep_local``), so the fits track the
sequential driver's to fp32 rounding, and a sweep's counted collective
bytes equal ``stationary_sweep_words`` times the itemsize, plus the fit's
all-reduce.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Sequence

import torch

from ..core.cp_als import CPResult
from ..core.tensor import frob_norm, random_factors
from ..observe import trace as _otrace
from . import collectives
from .grid_select import choose_cp_grid, stationary_sweep_words
from .mesh import GridMesh, make_grid_mesh, world_size
from .mttkrp_parallel import LocalFn, engine_local_fn, factor_block, gathered_block, tensor_block
from .ring import arrival_source, ring_all_gather_parts, ring_assemble, ring_reduce_scatter


def _sweep_local(x_loc, f_locs, blocks, grams, normx, *, mesh: GridMesh, local_fn: LocalFn,
                 compute_fit: bool, overlap: str = "none"):
    """One full ALS sweep (all N mode updates) on this rank's blocks.

    Carried state a factor k: the row block (I_k/P rows), the gathered
    block S^{(k)}_{p_k} (I_k/P_k rows, the same on every rank of the
    hyperslice), and the replicated Gram G_k = A_k^T A_k.

    ``overlap="ring"`` spells the two collectives of a factor as rings
    (:mod:`.ring`) and consumes factor ``mode-1``'s arrivals chunk by
    chunk inside mode ``mode``'s local MTTKRP: chunk t (from ring source
    ``(me - t) mod q``) multiplies the matching slice of ``x_loc`` along
    axis ``mode-1``. The arrivals are raw (λ is not known until the Gram
    all-reduce), so the chunked MTTKRP runs on raw blocks and its result is
    rescaled by ``1/λ`` a column: exact up to rounding, since the MTTKRP is
    linear in each factor column. The bytes are the same."""
    ring = overlap == "ring"
    ndim = mesh.ndim
    f_locs, blocks, grams = list(f_locs), list(blocks), list(grams)
    rank = f_locs[0].shape[-1]
    dtype = x_loc.dtype
    solve_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    eye = torch.eye(rank, dtype=solve_dtype, device=x_loc.device)
    weights = torch.ones((rank,), dtype=dtype, device=x_loc.device)
    b_last = a_last = None
    pending = None  # ring arrivals of factor mode-1, consumed chunk by chunk
    for mode in range(ndim):
        gamma = torch.ones((rank, rank), dtype=grams[0].dtype, device=x_loc.device)
        for k in range(ndim):
            if k != mode:
                gamma = gamma * grams[k]
        # MTTKRP on the carried gathered blocks (no gathers here: each was
        # made by the all-gather after its factor's update)
        mats = [blocks[k] if k != mode else None for k in range(ndim)]
        if pending is not None:
            parts, lam_prev, group_prev = pending
            pending = None
            prev = mode - 1
            q_prev = group_prev.size
            w = x_loc.shape[prev] // q_prev
            c = None
            for t, part in enumerate(parts):
                src = arrival_source(group_prev.me, t, q_prev)
                mats[prev] = part
                ct = local_fn(x_loc.narrow(prev, src * w, w), mats, mode)
                c = ct if c is None else c + ct
            c = c / lam_prev
        else:
            c = local_fn(x_loc, mats, mode)
        slab = mesh.hyperslice(mode)
        b_loc = ring_reduce_scatter(c, slab) if ring else collectives.reduce_scatter(c, slab)
        # normal-equations solve, rows local (Γ is replicated)
        gamma = gamma.to(solve_dtype)
        ridge = 1e-5 * torch.trace(gamma) / rank + 1e-12
        a_loc = torch.linalg.solve(gamma + ridge * eye, b_loc.to(solve_dtype).T).T.to(dtype)
        # the one all-gather of this factor for the sweep
        if ring:
            parts = ring_all_gather_parts(a_loc, slab)
            blk = ring_assemble(parts, slab)
        else:
            blk = collectives.all_gather(a_loc, slab)
        # the full Gram from the gathered block-rows: one R x R all-reduce
        # over the mode-n fiber (q = P_n), the sweep's only solve collective
        g_raw = collectives.all_reduce(blk.T @ blk, mesh.fiber(mode))
        lam = torch.clamp(torch.sqrt(torch.clamp(torch.diagonal(g_raw), min=0.0)),
                          min=1e-30).to(dtype)
        a_loc = a_loc / lam
        blk = blk / lam
        grams[mode] = g_raw / (lam[:, None] * lam[None, :])
        f_locs[mode] = a_loc
        blocks[mode] = blk
        if ring and mode < ndim - 1:
            # hand the raw arrivals to mode+1's chunked MTTKRP; λ rides
            # along so the consumer rescales without waiting on the ring
            pending = (parts, lam, slab)
        weights = lam
        b_last, a_last = b_loc, a_loc * lam
    if compute_fit:
        inner = collectives.all_reduce(torch.sum(b_last * a_last), mesh.grid_group())
        gram_full = torch.ones((rank, rank), dtype=grams[0].dtype, device=x_loc.device)
        for g in grams:
            gram_full = gram_full * g
        gram_full = gram_full * (weights[:, None] * weights[None, :])
        err_sq = torch.clamp(normx ** 2 - 2 * inner + torch.sum(gram_full), min=0.0)
        fit = 1.0 - torch.sqrt(err_sq) / torch.clamp(normx, min=1e-30)
    else:
        fit = torch.zeros((), dtype=dtype, device=x_loc.device)
    return tuple(f_locs), tuple(blocks), tuple(grams), weights, fit


def build_cp_sweep(mesh: GridMesh, ndim: int, *, ctx=None, local_fn: LocalFn | None = None,
                   compute_fit: bool = True) -> Callable:
    """The sweep ``f(x_loc, f_locs, blocks, grams, normx) -> (f_locs,
    blocks, grams, weights, fit)`` on this rank's carried state
    (:func:`place_cp_state`); ``ctx.distribution.overlap`` picks the
    collectives (``"none"`` or ``"ring"``)."""
    if mesh.p0 != 1:
        raise ValueError(
            "the CP-ALS sweep keeps X stationary (Algorithm 3); rank-axis "
            "(p0>1) meshes are for single-mode mttkrp_general"
        )
    if mesh.ndim != ndim:
        raise ValueError(f"grid {mesh.grid} is not {ndim}-way")
    if local_fn is None:
        local_fn = engine_local_fn(ctx)
    overlap = ctx.distribution.overlap if ctx is not None and ctx.distribution is not None \
        else "none"

    def sweep(x_loc, f_locs, blocks, grams, normx):
        return _sweep_local(x_loc, f_locs, blocks, grams, normx, mesh=mesh, local_fn=local_fn,
                            compute_fit=compute_fit, overlap=overlap)

    return sweep


def place_cp_state(mesh: GridMesh, x: torch.Tensor, factors: Sequence[torch.Tensor]):
    """This rank's carried state on its device: X's block (it never moves
    again), the factors' row blocks, their gathered block-rows, and the
    replicated Grams."""
    xs = tensor_block(x, mesh)
    fs = tuple(factor_block(f, mesh, k) for k, f in enumerate(factors))
    blocks = tuple(gathered_block(f, mesh, k) for k, f in enumerate(factors))
    grams = tuple((f.T @ f).to(mesh.device) for f in factors)
    return xs, fs, blocks, grams


def cp_als_parallel(
    x: torch.Tensor,
    rank: int,
    n_iters: int = 20,
    *,
    generator: torch.Generator | None = None,
    init_factors: Sequence[torch.Tensor] | None = None,
    ctx=None,
    tol: float = 0.0,
    compute_fit: bool = True,
) -> CPResult:
    """Distributed CP-ALS over the initialized default group, with
    automatic grid selection.

    Every rank calls it with the whole tensor ``x`` (and the same
    ``init_factors``, or the same ``generator`` seed). The grid comes from
    ``ctx.distribution``: an explicit ``grid`` is validated against the
    extents; else :func:`~.grid_select.choose_cp_grid` picks the Eq (12)
    sweep-optimal evenly-sharding grid for ``procs`` (default: the world
    size), which must then equal the world size. Each rank runs on
    ``cuda:{rank % device_count}`` (the CPU when ``ctx.device`` is
    ``"cpu"``). Factors come back as :func:`repro_torch.cp_als` returns
    them, column-normalized with the scales in ``CPResult.weights``, the
    same on every rank."""
    from ..engine.context import Distribution, ExecutionContext

    if ctx is None:
        ctx = ExecutionContext.default()
    if ctx.distribution is None:
        # this driver IS the distributed path: a plain context means
        # "select everything automatically"
        ctx = replace(ctx, distribution=Distribution())
    dist_cfg = ctx.distribution
    if dist_cfg.p0 != 1:
        raise ValueError(
            "the CP-ALS sweep keeps X stationary (Algorithm 3); rank-axis "
            "(p0>1) contexts are for single-mode mttkrp_general"
        )
    ctx.check_tensor("repro_torch.cp_als_parallel", x, *(init_factors or ()))
    ndim = x.ndim
    mesh = dist_cfg.mesh
    if mesh is None:
        grid = dist_cfg.grid
        if grid is None:
            procs = dist_cfg.procs if dist_cfg.procs is not None \
                else world_size("cp_als_parallel")
            grid = choose_cp_grid(x.shape, rank, procs).grid
        mesh = make_grid_mesh(grid, dims=x.shape, rank=rank, device=ctx.device)
    elif mesh.p0 != 1:
        raise ValueError("cp_als_parallel keeps X stationary; pass a p0=1 grid mesh")
    grid = mesh.grid
    if len(grid) != ndim:
        raise ValueError(f"grid {grid} is not {ndim}-way")

    if init_factors is not None:
        factors = [f.to(x.dtype) for f in init_factors]
    else:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        factors = random_factors(generator, x.shape, rank, x.dtype)
    fit_on = compute_fit or tol > 0
    sweep = build_cp_sweep(mesh, ndim, ctx=ctx, compute_fit=fit_on)
    xs, fs, blocks, grams = place_cp_state(mesh, x, factors)
    # ||X|| from the blocks: one scalar all-reduce, before the first sweep
    normx = torch.sqrt(collectives.all_reduce(frob_norm(xs) ** 2, mesh.grid_group()))

    observe = _otrace.should_record(ctx.observe)
    itemsize = x.element_size()
    fits: list[float] = []
    first = None
    weights = torch.ones((rank,), dtype=x.dtype, device=mesh.device)
    for it in range(n_iters):
        before = collectives.COUNTER.snapshot()
        fs, blocks, grams, weights, fit = sweep(xs, fs, blocks, grams, normx)
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
        nproc = mesh.layout.size
        modeled = int(stationary_sweep_words(x.shape, rank, grid))
        _otrace.record_event(
            "cp_sweep_collectives",
            shape=list(x.shape),
            rank=int(rank),
            grid=list(grid),
            procs=nproc,
            itemsize=itemsize,
            overlap=dist_cfg.overlap,
            measured_collective_bytes=int(collectives.ring_total(first)),
            modeled_words=modeled,
            modeled_bytes=modeled * itemsize,
            fit_allreduce_bytes=int(2 * (nproc - 1) / nproc * itemsize) if fit_on else 0,
            collectives_by_kind=first,
            transport=mesh.backend,
            measured_by="collective_wrappers",
        )
    # the result, the same on every rank: each factor's gathered block-rows
    # all-gathered over its mode-k fiber
    out = [collectives.all_gather(blocks[k], mesh.fiber(k)) for k in range(ndim)]
    return CPResult(out, weights, fits)
