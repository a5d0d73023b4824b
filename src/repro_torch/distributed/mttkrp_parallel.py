"""Parallel MTTKRP: Algorithm 3 (stationary tensor) and Algorithm 4
(general, rank-partitioned) as SPMD programs on ``torch.distributed``.
Counterpart of ``repro.distributed.mttkrp_parallel``.

Collective mapping (paper -> port):
  All-Gather over a hyperslice   -> collectives.all_gather(x, mesh.hyperslice(k))
  Reduce-Scatter over hyperslice -> collectives.reduce_scatter(c, mesh.hyperslice(n))

The data distributions follow §V-C1 / §V-D1, as the reference's
``PartitionSpec``s give them; here each is a function that cuts one rank's
block out of the global array:

  X       : block-distributed over the N-way grid (:func:`tensor_block`);
            Alg 4 also splits mode 0 across the rank axis, m0 major, r minor.
  A^(k)   : rows split by m{k} into the paper's S^{(k)}_{p_k} block-rows,
            each spread across its hyperslice (:func:`factor_block`), and
            for Alg 4 columns split by r.
  B^(n)   : the same layout as A^(n).

The reference's programs take global arrays and shard them inside one
``shard_map``; the port's take this rank's blocks (:func:`place_inputs`
cuts them) and return this rank's block of B^(n). Every collective adds
its bytes to ``collectives.COUNTER``, which the tests hold against
Eq (12)/(16) exactly.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from . import collectives
from .mesh import RANK_AXIS, GridMesh, mode_axis, row_sharding_axes

LocalFn = Callable[[torch.Tensor, Sequence[torch.Tensor | None], int], torch.Tensor]


def engine_local_fn(ctx=None) -> LocalFn:
    """This rank's MTTKRP through the engine, under ``ctx.local()``.

    Algorithms 3/4 own the collectives; the local MTTKRP inside each block
    is the sequential problem, so it runs through the same engine (on
    ``backend="cuda"`` the ``mttkrp3``/``mttkrpn`` kernels) as the
    single-device path. ``backend="auto"`` resolves against the tune cache
    keyed by the local block's shape."""
    from ..engine import execute as engine_execute  # call-time: layer cycle
    from ..engine.context import ExecutionContext

    if ctx is None:
        ctx = ExecutionContext.default()
    local_ctx = ctx.local()

    def fn(x, factors, mode):
        return engine_execute.mttkrp(x, factors, mode, ctx=local_ctx)

    return fn


def gather_factor(f_loc: torch.Tensor, mesh: GridMesh, k: int) -> torch.Tensor:
    """Line 4 of Alg 3/4: all-gather factor k's block-rows over the mode-k
    hyperslice, rebuilding S^{(k)}_{p_k} on every rank of it."""
    return collectives.all_gather(f_loc, mesh.hyperslice(k))


def gather_factors(
    f_locs: Sequence[torch.Tensor | None], mesh: GridMesh, skip: int | None = None
) -> list[torch.Tensor | None]:
    """One :func:`gather_factor` a non-``skip`` mode (``f_locs`` indexed by
    mode; ``None`` passes through). Alg 3/4 and the CP sweep share it."""
    return [None if (k == skip or f is None) else gather_factor(f, mesh, k)
            for k, f in enumerate(f_locs)]


# --------------------------------------------------------------------------
# The distributions: a rank's block of each global array
# --------------------------------------------------------------------------

def _rows(n: int, parts: int, index: int) -> slice:
    size = n // parts
    return slice(index * size, (index + 1) * size)


def _cut(t: torch.Tensor, index: tuple, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``t[index]`` on ``device`` (never a view that
    keeps the global array alive)."""
    block = t[index]
    out = torch.empty(block.shape, dtype=t.dtype, device=device)
    out.copy_(block)
    return out


def tensor_block(x: torch.Tensor, mesh: GridMesh,
                 rank_split_mode: int | None = None) -> torch.Tensor:
    """This rank's block of X: mode k split over m{k}; ``rank_split_mode``
    also split across the rank axis, m-axis major, r minor (Alg 4), so the
    rank-axis all-gather rebuilds the contiguous block."""
    index = []
    for k in range(x.ndim):
        pk = mesh.grid[k]
        if k == rank_split_mode:
            index.append(_rows(x.shape[k], pk * mesh.p0,
                               mesh.coord(mode_axis(k)) * mesh.p0 + mesh.coord(RANK_AXIS)))
        else:
            index.append(_rows(x.shape[k], pk, mesh.coord(mode_axis(k))))
    return _cut(x, tuple(index), mesh.device)


def factor_block(f: torch.Tensor, mesh: GridMesh, k: int,
                 rank_axis: bool = False) -> torch.Tensor:
    """This rank's block of A^(k): rows over ``row_sharding_axes`` (m{k},
    then the hyperslice), columns over r when ``rank_axis``."""
    axes = row_sharding_axes(mesh.ndim, k)
    parts = 1
    for a in axes:
        parts *= mesh.layout.shape[mesh.layout.names.index(a)]
    rows = _rows(f.shape[0], parts, mesh.linear(axes))
    cols = _rows(f.shape[1], mesh.p0, mesh.coord(RANK_AXIS)) if rank_axis else slice(None)
    return _cut(f, (rows, cols), mesh.device)


def output_block(b: torch.Tensor, mesh: GridMesh, mode: int,
                 rank_axis: bool = False) -> torch.Tensor:
    """This rank's block of a global B^(mode) (the layout of A^(mode))."""
    return factor_block(b, mesh, mode, rank_axis)


def gathered_block(f: torch.Tensor, mesh: GridMesh, k: int) -> torch.Tensor:
    """Factor k's gathered block-rows S^{(k)}_{p_k} on this rank: rows split
    by m{k} only (every rank of the hyperslice holds the same)."""
    return _cut(f, (_rows(f.shape[0], mesh.grid[k], mesh.coord(mode_axis(k))),), mesh.device)


# --------------------------------------------------------------------------
# Algorithm 3: stationary-tensor MTTKRP
# --------------------------------------------------------------------------

def _by_mode(f_locs: Sequence[torch.Tensor], ndim: int, mode: int) -> list:
    it = iter(f_locs)
    return [None if k == mode else next(it) for k in range(ndim)]


def mttkrp_stationary(mesh: GridMesh, mode: int, ndim: int, local_fn: LocalFn | None = None,
                      *, ctx=None):
    """Alg 3 as ``f(x_loc, *f_locs_except_mode) -> b_loc``, on this rank's
    blocks (:func:`place_inputs`). The tensor never moves; factor blocks
    are gathered and partial outputs reduce-scattered: Eq (12) a rank. The
    local MTTKRP goes through the engine under ``ctx``; an explicit
    ``local_fn`` overrides it."""
    if RANK_AXIS in mesh.layout.names:
        raise ValueError("mttkrp_stationary needs a p0=1 grid mesh; rank-axis meshes are "
                         "for mttkrp_general")
    if local_fn is None:
        local_fn = engine_local_fn(ctx)

    def fn(x_loc, *f_locs):
        # Line 4: A^(k)_{p_k} = All-Gather over the mode-k hyperslice
        gathered = gather_factors(_by_mode(f_locs, ndim, mode), mesh, skip=mode)
        # Line 6: local MTTKRP
        c = local_fn(x_loc, gathered, mode)
        # Line 7: Reduce-Scatter over the mode-n hyperslice
        return collectives.reduce_scatter(c, mesh.hyperslice(mode))

    return fn


# --------------------------------------------------------------------------
# Algorithm 4: general MTTKRP (rank-partitioned)
# --------------------------------------------------------------------------

def mttkrp_general(mesh: GridMesh, mode: int, ndim: int, local_fn: LocalFn | None = None,
                   *, ctx=None):
    """Alg 4 as ``f(x_loc, *f_locs_except_mode) -> b_loc`` on a mesh with a
    rank axis (``make_grid_mesh(grid, p0)``); Alg 3 is the case p0 == 1
    (the rank-axis collectives move nothing). Eq (16) a rank."""
    if local_fn is None:
        local_fn = engine_local_fn(ctx)

    def fn(x_loc, *f_locs):
        # Line 3: All-Gather the subtensor across the rank-axis fiber
        x_full = collectives.all_gather(x_loc, mesh.rank_fiber()) if mesh.p0 > 1 else x_loc
        # Line 5: gather factor block-rows over the mode-k hyperslices
        # (never across r: each rank slice keeps its own columns)
        gathered = gather_factors(_by_mode(f_locs, ndim, mode), mesh, skip=mode)
        # Line 7: local MTTKRP on the gathered subtensor and factor columns
        c = local_fn(x_full, gathered, mode)
        # Line 8: Reduce-Scatter over the mode-n hyperslice
        return collectives.reduce_scatter(c, mesh.hyperslice(mode))

    return fn


def place_inputs(mesh: GridMesh, x: torch.Tensor, factors: Sequence[torch.Tensor], mode: int,
                 rank_axis: bool = False):
    """This rank's blocks of X and of the non-mode factors in their §V
    distributions, on the rank's device: ``(x_loc, f_locs)``."""
    xs = tensor_block(x, mesh, rank_split_mode=0 if rank_axis else None)
    fs = tuple(factor_block(factors[k], mesh, k, rank_axis)
               for k in range(x.ndim) if k != mode)
    return xs, fs

