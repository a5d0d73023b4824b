"""ExecutionContext: the one immutable configuration object of the port.

Counterpart of ``repro.engine.context.ExecutionContext`` for this slice:
backend, :class:`~.plan.Memory`, dtype policy, and the device the entry
points run on. It is validated once, eagerly (``__post_init__``), and
round-trips through JSON under its own schema tag.

Backends: ``einsum`` (``torch.einsum``), ``blocked_host`` (Algorithm 2 as a
host-level einsum), ``cuda`` (the hand-written Hopper kernels) and ``auto``
(each contraction resolved through the tune cache, :mod:`repro_torch.tune`:
a hit replays the tuned backend and plan exactly, a miss takes ``cuda``
with the kernel's own plan on a CUDA tensor and ``einsum`` on the host;
``tune=True`` searches on a miss and persists the winner). On a CUDA
tensor ``cuda`` launches the kernels or raises; only a tensor that lies on
the CPU takes the kernels' plain versions.

The device defaults to ``"cuda"``: a context built on a host without CUDA
raises unless the caller asks for ``device="cpu"``.

:meth:`ExecutionContext.for_problem` resolves every ``"auto"`` choice of
one problem once (:class:`ProblemSpec`, :class:`PlanDecision`), so the
drivers replay decisions instead of looking them up a call.
``compilation_cache`` names the directory the kernels are built into and
loaded from (:meth:`ExecutionContext.ensure_compilation_cache`), the port's
counterpart of the reference's XLA compilation cache. ``observe=True`` opts
a context's calls into the span events of an active
:class:`repro_torch.observe.Trace`.

:meth:`ExecutionContext.default` is what every driver called without
``ctx`` runs under: the context that ``REPRO_TORCH_CONTEXT`` (a path to a
context JSON file, or the JSON text itself) seeds, else
``ExecutionContext()``. The port reads its own variable, not the
reference's ``REPRO_CONTEXT``: a reference context names
``backend="pallas"``, which this port refuses, and both packages may run
in one process.

A :class:`Distribution` (``create(distributed=True)``, or ``grid=``,
``procs=``, ``p0=``, ``overlap=``, ``mesh=``) selects the distributed
path: ``repro_torch.cp_als`` then runs the stationary sweep of
:mod:`repro_torch.distributed.cp_als_parallel` on the initialized
``torch.distributed`` default group, one rank a grid position
(``docs/PORT.md``).
"""

from __future__ import annotations

import functools
import json
import os
from dataclasses import dataclass, field, replace
from typing import Any, Mapping, Sequence

import torch

from .plan import Memory, keep_first

SCHEMA = "repro_torch.ExecutionContext/1"
ENV_CONTEXT = "REPRO_TORCH_CONTEXT"

#: The executors, and ``auto``, which resolves to one of them.
CONCRETE_BACKENDS = ("einsum", "blocked_host", "cuda")
VALID_BACKENDS = CONCRETE_BACKENDS + ("auto",)
_LATER = {
    "pallas": "the TPU kernels' counterparts here are backend='cuda'",
}


def check_backend(backend: str) -> None:
    """The backend validator: lists the valid values, and names the slice
    that brings a reference backend this port does not have yet."""
    if backend in _LATER:
        raise ValueError(f"backend={backend!r} is not available: {_LATER[backend]}")
    if backend not in VALID_BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {VALID_BACKENDS} "
            f"(einsum/blocked_host/cuda run directly, 'auto' resolves through the tune cache)"
        )


def dtype_name(dtype: str | torch.dtype) -> str:
    """``torch.bfloat16`` or ``"bfloat16"`` -> ``"bfloat16"`` (validated)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if not isinstance(getattr(torch, str(dtype), None), torch.dtype):
        raise ValueError(f"{dtype!r} is not a torch dtype")
    return str(dtype)


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, dtype_name(name))


def check_device(device: str | torch.device, api: str) -> torch.device:
    """The device an entry point runs on: 'cuda' (the default everywhere),
    which raises on a host without CUDA, or 'cpu' when the caller asks."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{api}(device='cuda'): this host has no CUDA device; "
            "pass device='cpu' to run on the host"
        )
    return dev


def check_driver_options(ctx: "ExecutionContext", *, mttkrp_fn: Any = None,
                         use_dimension_tree: bool = False) -> None:
    """Validate per-call driver arguments that are not part of the context
    (callables are not serialized) against it: the reference's errors."""
    if ctx.is_distributed:
        if mttkrp_fn is not None:
            raise ValueError(
                "mttkrp_fn cannot be combined with the distributed path "
                "(the sweep driver owns the collectives); drop mttkrp_fn or the "
                "distributed options (distributed/mesh/grid/procs)"
            )
        if use_dimension_tree:
            raise ValueError(
                "use_dimension_tree is not supported with distributed=True "
                "(the stationary sweep already amortizes factor gathers across "
                "all modes); drop one of the two options"
            )


@dataclass(frozen=True)
class Distribution:
    """The parallel machine (§V): the processor grid, the processor count,
    the rank-axis extent ``p0`` (Algorithm 4), and the sweep's collectives
    (``overlap``: ``"none"`` or ``"ring"``).

    ``check_rep`` is kept for the reference's dict and is inert: it steers
    ``shard_map``'s replication check there, and the port replicates
    nothing behind the caller's back. ``mesh`` is a process-local handle
    (a :class:`~repro_torch.distributed.mesh.GridMesh`), excluded from
    equality, hashing and serialization: a context round-trips by its grid
    and the mesh is rebuilt where it runs."""

    grid: tuple[int, ...] | None = None
    procs: int | None = None
    p0: int = 1
    check_rep: bool | None = None
    overlap: str = "none"
    mesh: Any = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.overlap not in ("none", "ring"):
            raise ValueError(
                f"overlap must be 'none' or 'ring' (ring = point-to-point "
                f"ring collectives feeding the local MTTKRP chunk by chunk), got "
                f"{self.overlap!r}"
            )
        if self.grid is not None:
            object.__setattr__(self, "grid", tuple(int(g) for g in self.grid))
            from ..distributed.mesh import validate_grid  # call-time: layer cycle

            # the process count is checked when the mesh is built (the
            # context itself stays portable across machines)
            validate_grid(self.grid, self.p0, check_devices=False)
        if self.procs is not None and self.procs < 1:
            raise ValueError(f"procs must be >= 1, got {self.procs}")
        if self.p0 < 1:
            raise ValueError(f"p0 must be >= 1, got {self.p0}")

    def to_dict(self) -> dict:
        return {
            "grid": list(self.grid) if self.grid is not None else None,
            "procs": self.procs,
            "p0": self.p0,
            "check_rep": self.check_rep,
            "overlap": self.overlap,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "Distribution":
        grid = d.get("grid")
        return cls(
            grid=tuple(grid) if grid is not None else None,
            procs=d.get("procs"),
            p0=int(d.get("p0", 1)),
            check_rep=d.get("check_rep"),
            overlap=str(d.get("overlap", "none")),
        )


@dataclass(frozen=True)
class ProblemSpec:
    """The (shape, rank, dtype) a context's decisions were resolved for;
    ``rank`` is the CP rank or the tuple of per-mode Tucker ranks."""

    shape: tuple[int, ...]
    rank: int | tuple[int, ...]
    dtype: str = "float32"

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        if isinstance(self.rank, (tuple, list)):
            object.__setattr__(self, "rank", tuple(int(r) for r in self.rank))
        object.__setattr__(self, "dtype", dtype_name(self.dtype))

    @property
    def is_multi_ttm(self) -> bool:
        return isinstance(self.rank, tuple)

    def to_dict(self) -> dict:
        rank = list(self.rank) if isinstance(self.rank, tuple) else self.rank
        return {"shape": list(self.shape), "rank": rank, "dtype": self.dtype}

    @classmethod
    def from_dict(cls, d: Mapping) -> "ProblemSpec":
        rank = d["rank"]
        rank = tuple(int(r) for r in rank) if isinstance(rank, list) else int(rank)
        return cls(tuple(d["shape"]), rank, str(d["dtype"]))


@dataclass(frozen=True)
class PlanDecision:
    """One replayed ``backend="auto"`` resolution: how mode ``mode`` of the
    pinned problem runs (a concrete backend, its exact plan, kernel variant,
    host block), and whether it came from the tune cache."""

    mode: int
    backend: str
    plan: object = None
    variant: str | None = None
    block: int | None = None
    cache_hit: bool = False

    def __post_init__(self):
        # a decision is a RESOLVED choice: a hand-edited "auto" or "pallas"
        # here would otherwise reach the dispatch layer's kernel branch
        if self.backend not in CONCRETE_BACKENDS:
            raise ValueError(
                f"PlanDecision backend must be a concrete executor {CONCRETE_BACKENDS}, "
                f"got {self.backend!r}"
            )

    def to_dict(self) -> dict:
        from ..tune.cache import plan_to_dict  # call-time: tune imports the engine

        return {"mode": self.mode, "backend": self.backend,
                "plan": plan_to_dict(self.plan) if self.plan is not None else None,
                "variant": self.variant, "block": self.block, "cache_hit": self.cache_hit}

    @classmethod
    def from_dict(cls, d: Mapping) -> "PlanDecision":
        from ..tune.cache import plan_from_dict  # call-time: tune imports the engine

        plan = d.get("plan")
        return cls(mode=int(d["mode"]), backend=str(d["backend"]),
                   plan=plan_from_dict(plan) if plan is not None else None,
                   variant=d.get("variant"), block=d.get("block"),
                   cache_hit=bool(d.get("cache_hit", False)))


@dataclass(frozen=True)
class ExecutionContext:
    """The execution environment, as one immutable, hashable value.

    Prefer the constructors: :meth:`create` (validate everything),
    :meth:`for_problem` (also resolve every ``"auto"`` choice of one
    problem once), :meth:`from_json` (replay a recorded setup)."""

    backend: str = "cuda"
    memory: Memory | None = None
    out_dtype: str | None = None
    compute_dtype: str | None = None
    device: str = "cuda"
    tune: bool = False
    cache_path: str | None = None
    problem: ProblemSpec | None = None
    decisions: tuple[PlanDecision, ...] = ()
    #: The distributed path's machine (None: one device).
    distribution: Distribution | None = None
    #: Opt this context's calls into the observability layer: span events
    #: into the active :class:`repro_torch.observe.Trace` (every call
    #: records under a ``capture="all"`` trace; only observed ones under
    #: ``capture="observed"``). Off by default.
    observe: bool = False
    #: Directory the Hopper kernels are built into and loaded from
    #: (:meth:`ensure_compilation_cache`): a second process serving the
    #: same buckets loads the libraries a first one built. None leaves
    #: ``kernels/_build/`` in use.
    compilation_cache: str | None = None

    def __post_init__(self):
        check_backend(self.backend)
        if self.memory is not None and not isinstance(self.memory, Memory):
            raise ValueError(
                f"memory must be a repro_torch.Memory (e.g. Memory.h100_smem()), "
                f"got {type(self.memory).__name__}"
            )
        if self.out_dtype is not None:
            object.__setattr__(self, "out_dtype", dtype_name(self.out_dtype))
        if self.compute_dtype is not None:
            name = dtype_name(self.compute_dtype)
            if not torch_dtype(name).is_floating_point:
                raise ValueError(
                    f"compute_dtype must be a float dtype (inputs are cast to it; "
                    f"accumulation stays fp32), got {name!r}"
                )
            object.__setattr__(self, "compute_dtype", name)
        object.__setattr__(self, "device", str(check_device(self.device, "ExecutionContext")))
        if self.tune and self.is_distributed:
            raise ValueError(
                "tune=True is not supported on the distributed path (a rank's local "
                "problem is not measured inside the sweep); pre-tune the local block "
                "shapes with mttkrp(..., ctx=ExecutionContext.create(backend='auto', "
                "tune=True)), then run distributed with backend='auto' to replay the cache"
            )
        if self.tune and self.backend != "auto":
            raise ValueError(
                f"tune=True requires backend='auto' (the search persists winners the auto "
                f"path replays); got backend={self.backend!r}"
            )
        object.__setattr__(self, "decisions", tuple(self.decisions))
        if self.decisions and self.problem is None:
            raise ValueError(
                "decisions without a problem spec: use for_problem(...) to pin plan "
                "resolutions"
            )
        if self.compilation_cache is not None and not isinstance(self.compilation_cache, str):
            raise ValueError(
                f"compilation_cache must be a directory path (str) or None, got "
                f"{type(self.compilation_cache).__name__}"
            )

    @classmethod
    def create(
        cls,
        backend: str = "cuda",
        *,
        memory: Memory | None = None,
        out_dtype: str | torch.dtype | None = None,
        compute_dtype: str | torch.dtype | None = None,
        device: str | torch.device = "cuda",
        tune: bool = False,
        cache_path: str | None = None,
        compilation_cache: str | None = None,
        distributed: bool = False,
        mesh=None,
        grid: Sequence[int] | None = None,
        procs: int | None = None,
        p0: int = 1,
        check_rep: bool | None = None,
        overlap: str = "none",
        observe: bool = False,
    ) -> "ExecutionContext":
        """Build and validate a context. Any of ``distributed=True``,
        ``mesh``, ``grid``, ``procs`` or ``overlap`` selects the distributed
        path (a :class:`Distribution` is attached); an explicit ``mesh``
        (a :class:`~repro_torch.distributed.mesh.GridMesh`) wins over
        ``grid``, which wins over the Eq (12) choice for ``procs``
        processors (default: the world size)."""
        dist = None
        if distributed or mesh is not None or grid is not None or procs is not None \
                or overlap != "none":
            if mesh is not None and grid is None:
                grid, p0 = mesh.grid, mesh.p0
            dist = Distribution(grid=tuple(grid) if grid is not None else None, procs=procs,
                                p0=p0, check_rep=check_rep, overlap=overlap, mesh=mesh)
        return cls(
            backend=backend,
            memory=memory,
            out_dtype=None if out_dtype is None else dtype_name(out_dtype),
            compute_dtype=None if compute_dtype is None else dtype_name(compute_dtype),
            device=str(device),
            tune=bool(tune),
            cache_path=cache_path,
            observe=bool(observe),
            compilation_cache=compilation_cache,
            distribution=dist,
        )

    @classmethod
    def for_problem(cls, shape: Sequence[int], rank, dtype="float32",
                    **kwargs) -> "ExecutionContext":
        """:meth:`create` and then :meth:`resolve_for` the problem: the
        per-mode ``"auto"`` decisions are resolved once against the tune
        cache. ``rank`` may be the tuple of Tucker ranks."""
        return cls.create(**kwargs).resolve_for(shape, rank, dtype)

    def resolve_for(self, shape, rank, dtype="float32") -> "ExecutionContext":
        """Pin this context to one problem. For ``backend="auto"`` without
        ``tune``: one decision a mode (``kind="mttkrp"``, the mode first),
        or for Tucker ranks one a kept mode and one for the full core
        (``kind="multi_ttm"``, keyed ``mode=-1``). With ``tune=True``
        nothing is pinned: the search needs data, so it runs at the first
        driver call and later calls replay the cache."""
        from ..tune.search import resolve, resolve_multi_ttm  # call-time: tune imports us

        shape = tuple(int(s) for s in shape)
        is_tucker = isinstance(rank, (tuple, list))
        rank = tuple(int(r) for r in rank) if is_tucker else int(rank)
        problem = ProblemSpec(shape, rank, dtype_name(dtype))
        if is_tucker and len(rank) != len(shape):
            raise ValueError(
                f"Tucker ranks {rank} must give one rank per tensor mode "
                f"({len(shape)} for shape {shape})"
            )
        if self.distribution is not None:
            # a distributed context pins the grid only: its engine work runs
            # on each rank's block shapes, where global decisions never replay
            return replace(self, distribution=self._resolve_grid(shape, rank, is_tucker),
                           problem=problem, decisions=())
        if self.backend != "auto" or self.tune:
            return replace(self, problem=problem, decisions=())
        cache = self.plan_cache()
        out = []
        if is_tucker:
            for keep_key in (-1,) + tuple(range(len(shape))):
                contracted = tuple(r for k, r in enumerate(rank) if k != keep_key)
                r = resolve_multi_ttm(keep_first(shape, max(keep_key, 0)), contracted,
                                      keep_key, problem.dtype, self.memory, cache=cache,
                                      device=self.device)
                out.append(PlanDecision(keep_key, r.backend, r.plan, r.variant, r.block,
                                        r.cache_hit))
        else:
            for mode in range(len(shape)):
                r = resolve(keep_first(shape, mode), rank, mode, problem.dtype, self.memory,
                            cache=cache, device=self.device)
                out.append(PlanDecision(mode, r.backend, r.plan, r.variant, r.block,
                                        r.cache_hit))
        return replace(self, problem=problem, decisions=tuple(out))

    def _resolve_grid(self, shape, rank, is_tucker: bool) -> Distribution:
        """The distribution with its grid chosen (Eq 12 sweep-optimal, or
        the Multi-TTM sweep objective for Tucker ranks) and validated
        against the extents; ``procs`` defaults to the world size."""
        from ..distributed import grid_select  # call-time: layer cycle
        from ..distributed.mesh import validate_grid, validate_tucker_grid, world_size

        dist = self.distribution
        grid = dist.grid
        if grid is None:
            procs = dist.procs if dist.procs is not None else world_size("resolve_for")
            grid = (grid_select.choose_tucker_grid(shape, rank, procs) if is_tucker
                    else grid_select.choose_cp_grid(shape, rank, procs)).grid
        if is_tucker:
            validate_tucker_grid(grid, dims=shape, check_devices=False)
        else:
            validate_grid(grid, dist.p0, dims=shape, rank=rank, check_devices=False)
        return replace(dist, grid=tuple(grid))

    @property
    def is_distributed(self) -> bool:
        return self.distribution is not None

    def local(self) -> "ExecutionContext":
        """A rank's view of a distributed context: the same engine knobs, no
        distribution (the collectives are owned by the driver; inside each
        block the problem is the sequential one)."""
        if self.distribution is None:
            return self
        return replace(self, distribution=None, problem=None, decisions=())

    def build_mesh(self, shape=None, rank: int | None = None):
        """The process-group mesh of the distributed path (an explicit mesh
        wins; else built from the resolved grid over the default group:
        collective, every rank calls it)."""
        if self.distribution is None:
            raise ValueError(
                "build_mesh() on a non-distributed context; pass "
                "distributed=True / grid= / procs= to create()"
            )
        if self.distribution.mesh is not None:
            return self.distribution.mesh
        if self.distribution.grid is None:
            raise ValueError(
                "no grid resolved yet: call resolve_for(shape, rank) / "
                "for_problem(...) first, or pass grid= explicitly"
            )
        from ..distributed.mesh import make_grid_mesh  # call-time: layer cycle

        return make_grid_mesh(self.distribution.grid, p0=self.distribution.p0, dims=shape,
                              rank=rank, device=self.device)

    def decision_for(self, shape, rank, mode: int, dtype=None) -> PlanDecision | None:
        """The pinned decision for ``mode``, or None when this context was
        not resolved for exactly this (shape, rank, dtype)."""
        if self.problem is None:
            return None
        rank = tuple(int(r) for r in rank) if isinstance(rank, (tuple, list)) else int(rank)
        if self.problem.shape != tuple(int(s) for s in shape) or self.problem.rank != rank:
            return None
        if dtype is not None and dtype_name(dtype) != self.problem.dtype:
            return None
        return next((d for d in self.decisions if d.mode == mode), None)

    def plan_cache(self):
        """The tune cache this context reads and writes (``cache_path``,
        else the process default), one instance a file in a process."""
        from ..tune.cache import shared_cache  # call-time: tune imports us

        return shared_cache(self.cache_path)

    def concrete(self, backend: str) -> "ExecutionContext":
        """This context on one resolved executor: no tuning, no pinned
        problem (the engine's ``auto`` branches dispatch through it, on
        every call: memoized)."""
        if self.backend == backend and not self.tune and self.problem is None:
            return self
        return _on_executor(self, backend)

    def ensure_compilation_cache(self) -> str | None:
        """Point the kernels' builds and loads at ``compilation_cache``
        (created if missing): every library this process builds from now
        on goes there, and one found there (same source hash) is loaded
        without ``nvcc``. Returns the directory in use; None when the field
        is None, and on a CPU context, which builds nothing.

        A library already loaded in this process stays loaded, from the
        directory it was built in, as the reference's memoized programs
        stay compiled (``repro_torch.kernels.build.loaded``)."""
        if self.compilation_cache is None or self.torch_device.type != "cuda":
            return None
        from ..kernels import build  # call-time: no kernel import for a CPU context

        os.makedirs(self.compilation_cache, exist_ok=True)
        return str(build.set_build_dir(self.compilation_cache))

    @property
    def torch_device(self) -> torch.device:
        return torch.device(self.device)

    def check_tensor(self, api: str, *tensors: torch.Tensor | None) -> None:
        """Raise unless every tensor lies on this context's device type:
        the entry points never move data behind the caller's back."""
        for t in tensors:
            if t is not None and t.device.type != self.torch_device.type:
                other = (f"build the context with device={t.device.type!r}"
                         if t.device.type in ("cuda", "cpu")
                         else "the context takes only device='cuda' or 'cpu'")
                raise ValueError(
                    f"{api}: tensor on {t.device} but the context runs on {self.device}; "
                    f"move it with .to({self.device!r}) or {other}"
                )

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        mem = None
        if self.memory is not None:
            mem = {
                "budget_bytes": self.memory.budget_bytes,
                "lane": self.memory.lane,
                "sublane": self.memory.sublane,
                "itemsize": self.memory.itemsize,
            }
        return {
            "schema": SCHEMA,
            "backend": self.backend,
            "memory": mem,
            "out_dtype": self.out_dtype,
            "compute_dtype": self.compute_dtype,
            "device": self.device,
            "tune": self.tune,
            "cache_path": self.cache_path,
            "problem": self.problem.to_dict() if self.problem is not None else None,
            "decisions": [d.to_dict() for d in self.decisions],
            "observe": self.observe,
            "compilation_cache": self.compilation_cache,
            "distribution": (self.distribution.to_dict()
                             if self.distribution is not None else None),
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "ExecutionContext":
        from ..convert import memory_from_dict  # call-time: convert imports the core

        schema = d.get("schema", SCHEMA)
        if schema != SCHEMA:
            raise ValueError(
                f"unsupported ExecutionContext schema {schema!r} (this build reads {SCHEMA!r})"
            )
        mem = d.get("memory")
        prob = d.get("problem")
        dist = d.get("distribution")
        return cls(
            backend=str(d.get("backend", "cuda")),
            memory=memory_from_dict(mem) if mem is not None else None,
            out_dtype=d.get("out_dtype"),
            compute_dtype=d.get("compute_dtype"),
            device=str(d.get("device", "cuda")),
            tune=bool(d.get("tune", False)),
            cache_path=d.get("cache_path"),
            problem=ProblemSpec.from_dict(prob) if prob is not None else None,
            decisions=tuple(PlanDecision.from_dict(x) for x in d.get("decisions", ())),
            observe=bool(d.get("observe", False)),
            compilation_cache=d.get("compilation_cache"),
            distribution=Distribution.from_dict(dist) if dist is not None else None,
        )

    def to_json(self, *, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ExecutionContext":
        """Inverse of :meth:`to_json`: ``from_json(ctx.to_json()) == ctx``."""
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=1))

    @classmethod
    def load(cls, path: str) -> "ExecutionContext":
        with open(path) as f:
            return cls.from_json(f.read())

    @classmethod
    def from_env(cls) -> "ExecutionContext | None":
        """The ``REPRO_TORCH_CONTEXT`` seed: a path to a context JSON file,
        or the JSON text itself. None when the variable is unset."""
        raw = os.environ.get(ENV_CONTEXT)
        if not raw:
            return None
        if os.path.exists(raw):
            return cls.load(raw)
        return cls.from_json(raw)

    @classmethod
    def default(cls) -> "ExecutionContext":
        """What a driver uses when handed no ``ctx``: the
        ``REPRO_TORCH_CONTEXT`` seed if set, else ``ExecutionContext()``
        (the card). Memoized on the raw value of the variable, so bare calls
        in a loop neither re-read a file nor re-parse JSON; a new value
        replaces the memo."""
        raw = os.environ.get(ENV_CONTEXT) or ""
        cached = _DEFAULT_MEMO.get(raw)
        if cached is None:
            cached = cls.from_env() or cls()
            _DEFAULT_MEMO.clear()  # the variable changed: the old seed is stale
            _DEFAULT_MEMO[raw] = cached
        return cached


#: :meth:`ExecutionContext.default`'s memo, keyed by the raw variable.
_DEFAULT_MEMO: dict[str, ExecutionContext] = {}


@functools.lru_cache(maxsize=64)
def _on_executor(ctx: ExecutionContext, backend: str) -> ExecutionContext:
    """:meth:`ExecutionContext.concrete`'s new context, memoized: ``replace``
    validates every field again, and ``auto`` asks on every engine call."""
    return replace(ctx, backend=backend, tune=False, problem=None, decisions=())
