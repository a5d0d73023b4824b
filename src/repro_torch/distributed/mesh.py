"""Logical processor grids for the parallel MTTKRP algorithms, as process
groups. Counterpart of ``repro.distributed.mesh``.

The paper organizes P processors as an N-way grid (Alg 3) or an (N+1)-way
grid with a leading rank axis P_0 (Alg 4). Mode-k axes are named
``m0..m{N-1}``, the rank axis ``r``. A mode-k *hyperslice* (the paper's
``procs(:, ..., :, p_k, :, ..., :)``) is the set of all axes except ``m{k}``
(and except ``r``: factor gathers never cross the rank axis).

The reference lays the grid over a device mesh and names axes inside one
``shard_map`` program. The port is SPMD: one process a grid position, each
process's global rank its row-major index over ``(r,) m0, ..., m{N-1}``
(the order ``jax.make_mesh`` lays devices in). A collective over a set of
axes runs on the process group of the ranks that share every other
coordinate, ordered row-major over those axes, first listed outermost: the
order ``all_gather(..., tiled=True)`` concatenates in.

* :class:`GridLayout` — the grid as rank lists, no processes
  (:func:`make_abstract_grid_mesh`, the counterpart of the reference's
  ``AbstractMesh`` twin); :func:`abstract_grid_mesh` makes one rank's
  :class:`GridMesh` of it over groups that move nothing (the
  ``"abstract"`` transport of :mod:`.collectives`), so one process can run
  every rank's program in turn and count its bytes.
* :class:`GridMesh` — the layout plus this process's groups, built from the
  initialized default group (:func:`make_grid_mesh`): one for each mode-k
  hyperslice, each mode-k fiber, the rank axis (Alg 4) and the whole grid.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import torch

from .collectives import ABSTRACT, Group

#: The Alg-4 rank-axis name; mode axes are spelled through :func:`mode_axis`.
RANK_AXIS = "r"


def mode_axis(k: int) -> str:
    return f"m{k}"


def world_size(what: str) -> int:
    """The initialized default group's size; ``what`` names the caller in
    the error raised when there is none."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what}: torch.distributed is not initialized; call "
            f"torch.distributed.init_process_group(...) on every rank first"
        )
    return dist.get_world_size()


def world_group() -> Group:
    """The whole initialized default group as one :class:`Group`, ranks in
    order: data parallelism's all-reduce (:mod:`.compression`). It is the
    grid group of the one-axis mesh ``(world size,)``, made without binding
    a device."""
    import torch.distributed as dist

    world = world_size("world_group")
    return Group(tuple(range(world)), dist.get_rank(), dist.group.WORLD if world > 1 else None,
                 str(dist.get_backend()))


def validate_grid(
    grid: Sequence[int],
    p0: int = 1,
    dims: Sequence[int] | None = None,
    rank: int | None = None,
    check_devices: bool = True,
) -> None:
    """Eagerly reject infeasible grids with actionable messages.

    Checks the grid itself (positive integer axes, P_0·ΠP_k within the
    default group's world size unless ``check_devices=False``: grid
    selection may target more processors than this run has) and, when
    ``dims``/``rank`` are given, the even-sharding requirements of the §V
    data distributions: ``P_k | I_k`` (X's block distribution),
    ``(P/P_0) | I_k`` (factor rows spread over every grid axis, as
    ``row_sharding_axes`` says), and for Alg 4 ``P_0 | R`` plus
    ``P_0·P_1 | I_1`` (X's mode-0 split across the rank axis). The single
    source of feasibility: ``grid_select.shardable`` delegates here. The
    messages are the reference's, the device count apart.
    """
    grid = tuple(grid)
    if not grid or any(g < 1 or g != int(g) for g in grid):
        raise ValueError(f"grid must be a non-empty tuple of positive ints, got {grid}")
    if p0 < 1:
        raise ValueError(f"p0 must be >= 1, got {p0}")
    if p0 > 1 and rank is not None and rank % p0:
        raise ValueError(f"rank axis p0={p0} does not divide R={rank}")
    if dims is not None:
        dims = tuple(dims)
        if len(dims) != len(grid):
            raise ValueError(
                f"grid {grid} is {len(grid)}-way but the tensor is {len(dims)}-way ({dims})"
            )
        mode_procs = math.prod(grid)
        for k, (d, pk) in enumerate(zip(dims, grid)):
            if d % pk:
                raise ValueError(
                    f"grid axis m{k}={pk} does not divide tensor extent "
                    f"I_{k}={d}: X cannot be block-distributed evenly"
                )
            if d % mode_procs:
                raise ValueError(
                    f"factor {k} rows (I_{k}={d}) are spread over all "
                    f"{mode_procs} grid processors but {mode_procs} does "
                    f"not divide {d}: uneven factor shards"
                )
        if p0 > 1:
            if dims[0] % (p0 * grid[0]):
                raise ValueError(
                    f"Alg 4 splits mode 0 across (r, m0) = "
                    f"{p0}x{grid[0]} but {p0 * grid[0]} does not divide "
                    f"I_0={dims[0]}"
                )
    if check_devices:
        total = p0 * math.prod(grid)
        nproc = world_size("validate_grid")
        if total > nproc:
            raise ValueError(
                f"grid {grid} with p0={p0} needs {total} processes but the "
                f"default group has {nproc} (start more ranks or shrink the grid)"
            )


def validate_tucker_grid(
    grid: Sequence[int],
    dims: Sequence[int] | None = None,
    check_devices: bool = True,
) -> None:
    """Feasibility of the Tucker/Multi-TTM stationary distribution: X
    block-distributed over the N-way grid (``P_k | I_k``), the factors
    replicated, so the CP driver's factor-row constraints do not apply.
    The single source of feasibility for ``grid_select.tucker_shardable``."""
    grid = tuple(grid)
    if not grid or any(g < 1 or g != int(g) for g in grid):
        raise ValueError(f"grid must be a non-empty tuple of positive ints, got {grid}")
    if dims is not None:
        dims = tuple(dims)
        if len(dims) != len(grid):
            raise ValueError(
                f"grid {grid} is {len(grid)}-way but the tensor is {len(dims)}-way ({dims})"
            )
        for k, (d, pk) in enumerate(zip(dims, grid)):
            if d % pk:
                raise ValueError(
                    f"grid axis m{k}={pk} does not divide tensor extent "
                    f"I_{k}={d}: X cannot be block-distributed evenly"
                )
    if check_devices:
        total = math.prod(grid)
        nproc = world_size("validate_tucker_grid")
        if total > nproc:
            raise ValueError(
                f"grid {grid} needs {total} processes but the default group has "
                f"{nproc} (start more ranks or shrink the grid)"
            )


def hyperslice_axes(ndim: int, k: int) -> tuple[str, ...]:
    """Axes of the mode-k hyperslice: every mode axis except m{k}. The
    gather and reduce-scatter collectives of Alg 3/4 run over these; the
    rank axis never does (factors are partitioned along r, not replicated)."""
    return tuple(mode_axis(j) for j in range(ndim) if j != k)


def row_sharding_axes(ndim: int, k: int) -> tuple[str, ...]:
    """The axes factor k's rows are split over: m{k} first (the paper's
    S^{(k)}_{p_k} block-rows), then spread across the hyperslice."""
    return (mode_axis(k),) + hyperslice_axes(ndim, k)


@dataclass(frozen=True)
class GridLayout:
    """The grid as rank lists: axes ``(r,) m0..m{N-1}``, global rank = the
    row-major index of a rank's coordinates."""

    grid: tuple[int, ...]
    p0: int = 1

    @property
    def ndim(self) -> int:
        return len(self.grid)

    @property
    def names(self) -> tuple[str, ...]:
        modes = tuple(mode_axis(k) for k in range(self.ndim))
        return modes if self.p0 == 1 else (RANK_AXIS,) + modes

    @property
    def shape(self) -> tuple[int, ...]:
        return self.grid if self.p0 == 1 else (self.p0,) + self.grid

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def coords(self, rank: int) -> dict[str, int]:
        """``{axis: index}`` of a global rank."""
        out, rest = {}, rank
        for name, n in reversed(tuple(zip(self.names, self.shape))):
            out[name] = rest % n
            rest //= n
        return {name: out[name] for name in self.names}

    def rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for name, n in zip(self.names, self.shape):
            r = r * n + coords[name]
        return r

    def linear(self, rank: int, axes: Sequence[str]) -> int:
        """A rank's row-major index over ``axes`` (first listed outermost)."""
        c = self.coords(rank)
        idx = 0
        for a in axes:
            idx = idx * self.shape[self.names.index(a)] + c[a]
        return idx

    def ranks_along(self, rank: int, axes: Sequence[str]) -> tuple[int, ...]:
        """The ranks that share every coordinate of ``rank`` off ``axes``,
        ordered by :meth:`linear` over ``axes``."""
        base = self.coords(rank)
        sizes = [self.shape[self.names.index(a)] for a in axes]
        out = []
        for flat in range(math.prod(sizes)):
            c, rest = dict(base), flat
            for a, n in reversed(tuple(zip(axes, sizes))):
                c[a] = rest % n
                rest //= n
            out.append(self.rank_of(c))
        return tuple(out)

    def partition(self, axes: Sequence[str]) -> list[tuple[int, ...]]:
        """Every group of ``axes``: the rank lists :meth:`ranks_along`
        gives, each once, in the order of their first rank."""
        seen, out = set(), []
        for r in range(self.size):
            if r not in seen:
                group = self.ranks_along(r, axes)
                seen.update(group)
                out.append(group)
        return out

    def group_axes(self) -> list[tuple[str, ...]]:
        """The axis sets the algorithms run collectives over, each once:
        every mode-k hyperslice and fiber, the rank axis, the whole grid."""
        out: list[tuple[str, ...]] = []
        for k in range(self.ndim):
            for axes in (hyperslice_axes(self.ndim, k), (mode_axis(k),)):
                if axes not in out:
                    out.append(axes)
        if self.p0 > 1:
            out.append((RANK_AXIS,))
        grid_axes = tuple(mode_axis(k) for k in range(self.ndim))
        if grid_axes not in out:
            out.append(grid_axes)
        return out


@dataclass
class GridMesh:
    """A :class:`GridLayout` as this process sees it: its global rank, its
    device, and one :class:`~.collectives.Group` for each axis set of
    :meth:`GridLayout.group_axes`."""

    layout: GridLayout
    rank: int
    device: torch.device
    backend: str
    groups: dict[tuple[str, ...], Group] = field(repr=False)

    @property
    def grid(self) -> tuple[int, ...]:
        return self.layout.grid

    @property
    def p0(self) -> int:
        return self.layout.p0

    @property
    def ndim(self) -> int:
        return self.layout.ndim

    def coord(self, name: str) -> int:
        return self.layout.coords(self.rank)[name]

    def linear(self, axes: Sequence[str]) -> int:
        return self.layout.linear(self.rank, axes)

    def group(self, axes: Sequence[str]) -> Group:
        return self.groups[tuple(axes)]

    def hyperslice(self, k: int) -> Group:
        return self.group(hyperslice_axes(self.ndim, k))

    def fiber(self, k: int) -> Group:
        return self.group((mode_axis(k),))

    def rank_fiber(self) -> Group:
        return self.group((RANK_AXIS,))

    def grid_group(self) -> Group:
        """The ranks of this rank-axis slice's whole grid (all ranks when
        ``p0 == 1``): the fit's all-reduce."""
        return self.group(tuple(mode_axis(k) for k in range(self.ndim)))


def rank_device(device: str | torch.device, rank: int) -> torch.device:
    """This rank's device: ``cuda:{rank % device_count}`` for ``"cuda"``
    (made current), the CPU only when asked for. Raises without CUDA."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"rank {rank} was asked for device 'cuda' but this host has no CUDA device; "
            "pass device='cpu' to run on the host"
        )
    dev = torch.device("cuda", rank % torch.cuda.device_count() if dev.index is None
                       else dev.index)
    torch.cuda.set_device(dev)
    return dev


#: Built meshes, by (grid, p0, device type), for the default group they
#: were built from: ``make_grid_mesh`` is collective, so every rank hits or
#: misses together, and the groups are made once a run.
_MESHES: dict[tuple, tuple[object, GridMesh]] = {}


def make_grid_mesh(
    grid: Sequence[int],
    p0: int = 1,
    dims: Sequence[int] | None = None,
    rank: int | None = None,
    device: str | torch.device = "cuda",
) -> GridMesh:
    """The mesh for Alg 3 (``p0=1``) or Alg 4 (``p0>1``) over the
    initialized default group, which must hold exactly ``p0 * prod(grid)``
    ranks (one a grid position). Validates eagerly (:func:`validate_grid`,
    with ``dims``/``rank`` for the even-sharding checks). Collective: every
    rank calls it with the same arguments, and the process groups are made
    on the first call (``torch.distributed.new_group``, in one order on
    every rank)."""
    import torch.distributed as dist

    grid = tuple(int(g) for g in grid)
    validate_grid(grid, p0, dims, rank)
    layout = GridLayout(grid, p0)
    world = dist.get_world_size()
    if world != layout.size:
        raise ValueError(
            f"grid {grid} with p0={p0} spans {layout.size} ranks but the default group "
            f"has {world}: every rank of the program holds one grid position"
        )
    me = dist.get_rank()
    dev = rank_device(device, me)
    key = (grid, p0, dev.type)
    hit = _MESHES.get(key)
    if hit is not None and hit[0] is dist.group.WORLD:
        return hit[1]
    backend = str(dist.get_backend())
    groups: dict[tuple[str, ...], Group] = {}
    for axes in layout.group_axes():
        for ranks in layout.partition(axes):
            if len(ranks) == 1:
                pg = None
            elif len(ranks) == world:
                pg = dist.group.WORLD
            else:
                pg = dist.new_group(list(ranks))  # every rank makes every group
            if me in ranks:
                groups[axes] = Group(ranks, ranks.index(me), pg, backend)
    mesh = GridMesh(layout, me, dev, backend, groups)
    _MESHES[key] = (dist.group.WORLD, mesh)
    return mesh


def make_abstract_grid_mesh(grid: Sequence[int], p0: int = 1) -> GridLayout:
    """Process-free twin of :func:`make_grid_mesh`: the same layout as rank
    lists (:meth:`GridLayout.partition`), with no device-count check."""
    validate_grid(grid, p0, check_devices=False)
    return GridLayout(tuple(int(g) for g in grid), p0)


def abstract_grid_mesh(layout: GridLayout, rank: int) -> GridMesh:
    """Rank ``rank``'s :class:`GridMesh` of ``layout`` on the CPU, its groups
    on the ``"abstract"`` transport (:data:`~.collectives.ABSTRACT`): the
    sweep builders run unchanged over it and count this rank's collective
    bytes, with no process group and no second process."""
    if not 0 <= rank < layout.size:
        raise ValueError(f"rank {rank} outside the {layout.size} ranks of grid {layout.grid}")
    groups: dict[tuple[str, ...], Group] = {}
    for axes in layout.group_axes():
        for ranks in layout.partition(axes):
            if rank in ranks:
                groups[axes] = Group(ranks, ranks.index(rank), None, ABSTRACT)
    return GridMesh(layout, rank, torch.device("cpu"), ABSTRACT, groups)
