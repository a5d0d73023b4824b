"""Persistent plan cache: tuned plans keyed by the full problem.
Counterpart of ``repro.tune.cache``.

One JSON file holds every tuned decision on this machine. An entry records
everything the engine needs to replay the winner without searching again:
backend, kernel variant, host block, and the exact plan, round-tripped
field for field and tagged by its type, so a cached plan comes back as the
type it was: the reference's :class:`~repro_torch.engine.plan.BlockPlan`
and :class:`~repro_torch.engine.plan.MultiTTMPlan`, and the Hopper kernels'
own :class:`~repro_torch.engine.plan.MTTKRPKernelPlan`,
:class:`~repro_torch.engine.plan.MultiTTMKernelPlan` and
:class:`~repro_torch.engine.plan.PartialKernelPlan`.

Keying: :func:`cache_key` keeps every field of the reference's key, in the
same order, up to its last two: ``platform=`` is the CUDA device's name on
``cuda`` (``cpu`` on the host) and ``torch=`` the torch version, where the
reference has ``platform=<jax backend>`` and ``jax=<version>``. A winner
measured on one card is never replayed on another. ``SCHEMA_VERSION`` is
part of the file's envelope: a file of another version is dropped whole.

A corrupted, truncated or wrong-schema file never takes the engine down:
a load falls back to an empty cache and the next ``put`` rewrites the file
atomically.

The path resolves, in order: explicit argument, ``REPRO_TORCH_TUNE_CACHE``,
``~/.cache/repro-mttkrp-torch/plans.json``. The port never reads or writes
the reference's file.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import tempfile
import time
from dataclasses import asdict, dataclass, field
from typing import Iterator, Sequence

import torch

from ..engine.context import dtype_name
from ..engine.plan import (
    BlockPlan,
    Memory,
    MTTKRPKernelPlan,
    MultiTTMKernelPlan,
    MultiTTMPlan,
    PartialKernelPlan,
)

SCHEMA_VERSION = 1
ENV_CACHE_PATH = "REPRO_TORCH_TUNE_CACHE"
DEFAULT_CACHE_PATH = os.path.join("~", ".cache", "repro-mttkrp-torch", "plans.json")

Plan = BlockPlan | MultiTTMPlan | MTTKRPKernelPlan | MultiTTMKernelPlan | PartialKernelPlan

#: The kernels' plans, by the ``type`` tag of their serialized form; each is
#: a flat dataclass of ints (and the partial kernel's layout string).
_KERNEL_PLANS = {cls.__name__: cls
                 for cls in (MTTKRPKernelPlan, MultiTTMKernelPlan, PartialKernelPlan)}


def resolve_cache_path(path: str | None = None) -> str:
    """Explicit path > ``$REPRO_TORCH_TUNE_CACHE`` > the default user cache."""
    if path is None:
        path = os.environ.get(ENV_CACHE_PATH) or DEFAULT_CACHE_PATH
    return os.path.expanduser(path)


# ---------------------------------------------------------------------------
# Plan (de)serialization: exact round trip, tagged by type
# ---------------------------------------------------------------------------

def plan_to_dict(plan: Plan) -> dict:
    """A plan as JSON-ready fields plus its ``type``. ``BlockPlan`` and
    ``MultiTTMPlan`` keep the reference's fields (``plan_from_dict`` also
    reads the reference's untagged form)."""
    if isinstance(plan, MultiTTMPlan):
        return {"type": "MultiTTMPlan", "block_i": plan.block_i,
                "block_contract": list(plan.block_contract), "ranks": list(plan.ranks)}
    if isinstance(plan, BlockPlan):
        return {"type": "BlockPlan", "block_i": plan.block_i,
                "block_contract": list(plan.block_contract), "block_r": plan.block_r,
                "x_has_rank": plan.x_has_rank}
    if type(plan).__name__ in _KERNEL_PLANS:
        return {"type": type(plan).__name__, **asdict(plan)}
    raise TypeError(f"not a plan: {type(plan).__name__}")


def plan_from_dict(d: dict) -> Plan:
    """Inverse of :func:`plan_to_dict`: the plan as the type it was."""
    kind = d.get("type")
    if kind in _KERNEL_PLANS:
        cls = _KERNEL_PLANS[kind]
        fields = cls.__dataclass_fields__
        return cls(**{k: (str(d[k]) if k == "layout" else int(d[k])) for k in fields})
    if kind == "MultiTTMPlan" or (kind is None and "ranks" in d):
        return MultiTTMPlan(
            block_i=int(d["block_i"]),
            block_contract=tuple(int(c) for c in d["block_contract"]),
            ranks=tuple(int(r) for r in d["ranks"]),
        )
    if kind not in (None, "BlockPlan"):
        raise ValueError(f"unknown plan type {kind!r}")
    return BlockPlan(
        block_i=int(d["block_i"]),
        block_contract=tuple(int(c) for c in d["block_contract"]),
        block_r=int(d["block_r"]),
        x_has_rank=bool(d.get("x_has_rank", False)),
    )


def memory_tag(memory: Memory) -> str:
    return f"{memory.budget_bytes}:{memory.lane}:{memory.sublane}:{memory.itemsize}"


@functools.lru_cache(maxsize=16)
def platform_tag(device: str | torch.device | None = None) -> str:
    """The key's platform: the CUDA device's name (``torch.cuda.
    get_device_name``) for a ``cuda`` device, ``cpu`` for the host. ``None``
    is the port's default device: ``cuda`` where there is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def cache_key(
    shape: Sequence[int],
    rank: int | Sequence[int],
    mode: int,
    dtype,
    memory: Memory,
    *,
    kind: str = "mttkrp",
    device: str | torch.device | None = None,
) -> str:
    """The tuning problem's identity: every field that changes the answer.

    ``rank`` is the CP rank, or for ``kind="multi_ttm"`` the tuple of
    Tucker ranks (tagged ``r1xr2x...``); ``mode`` is the output or kept mode
    (``-1``: the full Tucker core, or a whole sweep). ``dtype`` is a torch
    dtype or its name, written as the reference writes it (``float32``,
    ``bfloat16``). ``device`` is where the problem runs (its platform
    field)."""
    rank = tuple(int(r) for r in rank) if isinstance(rank, (tuple, list)) else int(rank)
    return _key(tuple(int(s) for s in shape), rank, int(mode), dtype, memory, kind,
                device if device is None or isinstance(device, str) else str(device))


@functools.lru_cache(maxsize=1024)
def _key(shape, rank, mode, dtype, memory, kind, device) -> str:
    """:func:`cache_key` of hashable arguments, memoized: the engine's
    ``auto`` branches build a key on every call."""
    rank_tag = "x".join(map(str, rank)) if isinstance(rank, tuple) else str(rank)
    return (
        f"{kind}|shape={'x'.join(map(str, shape))}|rank={rank_tag}|mode={mode}"
        f"|dtype={dtype_name(dtype)}|mem={memory_tag(memory)}"
        f"|platform={platform_tag(device)}|torch={torch.__version__}"
    )


@dataclass
class CacheEntry:
    """One tuned decision: how to run this contraction, and why."""

    backend: str
    plan: dict | None = None  # plan_to_dict payload; None for einsum
    variant: str | None = None  # 3-way kernel variant, or the sweep schedule
    block: int | None = None  # blocked_host uniform block
    metric: str = "walltime"
    score: float = float("nan")  # winning score (us or modeled bytes)
    walltime_us: float = float("nan")
    modeled_bytes: int | None = None
    timestamp: float = 0.0
    meta: dict = field(default_factory=dict)

    def to_plan(self) -> Plan | None:
        return plan_from_dict(self.plan) if self.plan is not None else None

    @classmethod
    def from_dict(cls, d: dict) -> "CacheEntry":
        known = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in known})


class PlanCache:
    """On-disk JSON plan cache with in-process memoization.

    The file is a versioned envelope::

        {"schema": 1, "torch": "...", "entries": {key: entry, ...}, "calibration": {...}}

    Loads are lazy and forgiving (any parse or schema problem gives an empty
    cache); writes go through a temp file in the same directory and
    ``os.replace``, so a crash mid-write never leaves half a file.
    """

    def __init__(self, path: str | None = None):
        self.path = resolve_cache_path(path)
        self._entries: dict[str, CacheEntry] | None = None
        self._calibration: dict | None = None
        #: Hits already checked, by the resolver's arguments
        #: (``tune.search._checked``): a hit replays one without rebuilding
        #: and re-checking its plan. Every write empties it, so an entry put,
        #: dropped or cleared is looked up anew.
        self.checked: dict = {}

    def _load(self) -> dict[str, CacheEntry]:
        if self._entries is not None:
            return self._entries
        entries: dict[str, CacheEntry] = {}
        calibration: dict | None = None
        try:
            with open(self.path) as f:
                raw = json.load(f)
            if (isinstance(raw, dict) and raw.get("schema") == SCHEMA_VERSION
                    and isinstance(raw.get("entries"), dict)):
                for k, v in raw["entries"].items():
                    try:
                        entries[k] = CacheEntry.from_dict(v)
                    except (TypeError, KeyError, ValueError, AttributeError):
                        continue  # skip one bad entry, keep the rest
                cal = raw.get("calibration")
                calibration = cal if isinstance(cal, dict) else None
            # another schema or shape: treated as empty (the whole file goes)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            pass  # missing or corrupted file: start empty, never crash
        self._entries = entries
        self._calibration = calibration
        return entries

    def _flush(self) -> None:
        entries = self._load()
        payload = {
            "schema": SCHEMA_VERSION,
            "torch": torch.__version__,
            "entries": {k: asdict(e) for k, e in entries.items()},
        }
        if self._calibration is not None:
            payload["calibration"] = self._calibration
        d = os.path.dirname(self.path) or "."
        try:
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            pass  # a read-only file system: the in-process cache still works

    def get(self, key: str) -> CacheEntry | None:
        return self._load().get(key)

    def put(self, key: str, entry: CacheEntry, persist: bool = True) -> None:
        if not entry.timestamp:
            entry.timestamp = time.time()
        self._load()[key] = entry
        self.checked.clear()
        if persist:
            self._flush()

    def invalidate(self, key: str) -> None:
        self._load().pop(key, None)
        self.checked.clear()
        self._flush()

    def clear(self) -> None:
        self._entries = {}
        self._calibration = None
        self.checked.clear()
        self._flush()

    def keys(self) -> list[str]:
        return sorted(self._load())

    def __len__(self) -> int:
        return len(self._load())

    def get_calibration(self) -> dict | None:
        self._load()
        return self._calibration

    def put_calibration(self, cal: dict) -> None:
        self._load()
        self._calibration = cal
        self._flush()


# process-wide caches, one per resolved path (so a test can redirect
# REPRO_TORCH_TUNE_CACHE and get a fresh instance)
_SHARED_CACHES: dict[str, PlanCache] = {}
#: The same instances by the path as given (absolute, or relative to the
#: working directory), so an ``auto`` engine call skips ``expanduser``.
_BY_GIVEN: dict[str, PlanCache] = {}


def shared_cache(path: str | None = None) -> PlanCache:
    """This process's one :class:`PlanCache` on ``path`` (the file is read
    once, not on every ``auto`` engine call)."""
    given = path if path is not None else os.environ.get(ENV_CACHE_PATH)
    cache = _BY_GIVEN.get(given) if given is not None else None
    if cache is None:
        path = resolve_cache_path(given)
        cache = _SHARED_CACHES.get(path)
        if cache is None:
            cache = _SHARED_CACHES[path] = PlanCache(path)
        if given is not None and not given.startswith("~"):
            _BY_GIVEN[given] = cache
    return cache


def default_cache() -> PlanCache:
    return shared_cache()


@contextlib.contextmanager
def isolated_cache() -> Iterator[str]:
    """Redirect the default cache to a throwaway temp file for the scope
    (benchmarks and demos never touch the user's plan cache). Restores
    ``REPRO_TORCH_TUNE_CACHE`` and removes the file on exit."""
    fd, tmp = tempfile.mkstemp(prefix="repro-torch-tune-", suffix=".json")
    os.close(fd)
    prev = os.environ.get(ENV_CACHE_PATH)
    os.environ[ENV_CACHE_PATH] = tmp
    try:
        yield tmp
    finally:
        if prev is None:
            os.environ.pop(ENV_CACHE_PATH, None)
        else:
            os.environ[ENV_CACHE_PATH] = prev
        with contextlib.suppress(OSError):
            os.unlink(tmp)
