"""The collectives of Algorithms 3 and 4 on ``torch.distributed`` groups,
each counted in bytes.

Counterparts of what the reference's ``shard_map`` programs call:

    lax.all_gather(x, axes, axis=0, tiled=True)       -> all_gather(x, group)
    lax.psum_scatter(c, axes, scatter_dimension=0,
                     tiled=True)                      -> reduce_scatter(c, group)
    lax.psum(x, axes)                                 -> all_reduce(x, group)
    lax.ppermute(x, axes, ring_perm(q))               -> permute(x, group)

The reference measures its collectives by walking compiled HLO
(``distributed/hlo.py``); the port compiles no HLO, so every call here adds
its bytes to :data:`COUNTER` under the same ring rule (``hlo.py``'s
``CollectiveOp.ring_bytes``), from this rank's own operand and result:

    all-gather          (q-1) · operand bytes
    reduce-scatter      (q-1) · output bytes
    all-reduce          int(2(q-1)/q · operand bytes)
    all-to-all          int((q-1)/q · operand bytes)
    collective-permute  operand bytes (one hop)

A group of one process moves nothing and counts nothing, as XLA drops such
collectives. Each kind also sums the host seconds its calls took (the
payload's stream synchronized first on gloo, so pending kernels are not
charged to the collective), which is how a rank splits an iteration
between its collectives and its local work.

The transport is the group's backend. NCCL takes CUDA tensors where each
rank has a card of its own. Gloo takes host tensors: a CUDA payload is
copied to the host before the call and back after it, explicitly, and its
bytes are counted once (the collective's, not the copies'). So several
ranks can share one card over gloo, which NCCL refuses. A collective that
fails raises; nothing switches transport behind the caller's back.

The ``"abstract"`` backend (:data:`ABSTRACT`, a group with ``pg=None``)
moves nothing and needs no process group: each call returns the result's
shape as if every rank of the group held this rank's operand (an
all-gather q copies, an all-reduce q times the operand, a reduce-scatter q
times this rank's chunk, a permute the operand) and counts the same ring
bytes as a real group. So one process runs every rank's program of a grid
in turn (:func:`~.mesh.abstract_grid_mesh`) and counts each rank's bytes:
``repro_torch.verify.comm``. Only the shapes and the bytes mean anything
there; the values stay finite, so the sweeps' solves run.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Mapping

import torch

KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all", "collective-permute")
#: The backend of a group that moves nothing (see the module docstring).
ABSTRACT = "abstract"


@dataclass(frozen=True)
class Group:
    """One process group of a grid: the global ranks in the group's linear
    order (row-major over its axes), this process's index among them, the
    ``torch.distributed`` group (None for a group of one) and its backend."""

    ranks: tuple[int, ...]
    me: int
    pg: object
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)


def ring_bytes(kind: str, operand_bytes: int, output_bytes: int, q: int) -> int:
    """Per-rank link bytes of one collective over ``q`` ranks under the
    ring model (the reference's ``distributed/hlo.py`` rule; all-to-all's
    is ``analysis/hlo_cost.py``'s)."""
    if kind == "all-gather":
        return (q - 1) * operand_bytes
    if kind == "reduce-scatter":
        return (q - 1) * output_bytes
    if kind == "all-reduce":
        return int(2 * (q - 1) / q * operand_bytes)
    if kind == "all-to-all":
        return int((q - 1) / q * operand_bytes)
    if kind == "collective-permute":
        return operand_bytes
    raise ValueError(f"unknown collective kind {kind!r}; expected one of {KINDS}")


class CollectiveCounter:
    """This process's collectives, by kind: count, operand bytes, ring
    bytes and host seconds. Read with snapshot deltas::

        before = COUNTER.snapshot()
        ...collectives...
        delta = COUNTER.delta(before)   # {"all-gather": {"count": 3, ...}}
        total = ring_total(delta)
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_kind: dict[str, dict[str, int]] = {}

    def add(self, kind: str, operand_bytes: int, ring: int, seconds: float = 0.0) -> None:
        with self._lock:
            d = self._by_kind.setdefault(
                kind, {"count": 0, "operand_bytes": 0, "ring_bytes": 0, "seconds": 0.0})
            d["count"] += 1
            d["operand_bytes"] += int(operand_bytes)
            d["ring_bytes"] += int(ring)
            d["seconds"] += seconds

    def snapshot(self) -> dict[str, dict[str, int]]:
        with self._lock:
            return {k: dict(v) for k, v in self._by_kind.items()}

    def delta(self, before: Mapping[str, Mapping[str, int]]) -> dict[str, dict[str, int]]:
        out = {}
        for kind, now in self.snapshot().items():
            was = before.get(kind, {})
            d = {f: now[f] - was.get(f, 0) for f in now}
            if d["count"]:
                out[kind] = d
        return out


def ring_total(by_kind: Mapping[str, Mapping[str, int]]) -> int:
    """Ring bytes summed over kinds (a :meth:`CollectiveCounter.delta`)."""
    return sum(int(d["ring_bytes"]) for d in by_kind.values())


def seconds_total(by_kind: Mapping[str, Mapping[str, float]]) -> float:
    """Host seconds summed over kinds (a :meth:`CollectiveCounter.delta`)."""
    return sum(float(d["seconds"]) for d in by_kind.values())


#: The process's counter: every collective below adds to it.
COUNTER = CollectiveCounter()


def _start(x: torch.Tensor, group: Group) -> float:
    """The clock of one call: on gloo a CUDA payload's stream is drained
    first (its host copy would wait for it anyway)."""
    if x.is_cuda and group.backend == "gloo":
        torch.cuda.synchronize(x.device)
    return time.perf_counter()


def _count(kind: str, group: Group, operand: torch.Tensor, output: torch.Tensor,
           t0: float) -> None:
    ob = operand.numel() * operand.element_size()
    outb = output.numel() * output.element_size()
    COUNTER.add(kind, ob, ring_bytes(kind, ob, outb, group.size), time.perf_counter() - t0)


def _host(x: torch.Tensor, group: Group, copy: bool = False) -> torch.Tensor:
    """The payload as the transport takes it: gloo a contiguous host copy
    of a CUDA tensor, anything else the tensor itself (a copy when
    ``copy``: the transport writes into it), contiguous."""
    to = torch.device("cpu") if x.is_cuda and group.backend == "gloo" else x.device
    return x.detach().to(to, copy=copy or to != x.device).contiguous()


def _back(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y.to(like.device) if y.device != like.device else y


def _abstract(group: Group) -> bool:
    return group.backend == ABSTRACT and group.pg is None


def all_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``lax.all_gather(x, axes, axis=0, tiled=True)``: every rank's ``x``
    concatenated along dim 0 in the group's order."""
    if group.size == 1:
        return x
    if _abstract(group):
        out = torch.cat([x] * group.size, dim=0)
        _count("all-gather", group, x, out, time.perf_counter())
        return out
    import torch.distributed as dist

    t0 = _start(x, group)
    src = _host(x, group)
    parts = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(parts, src, group=group.pg)
    out = _back(torch.cat(parts, dim=0), x)
    _count("all-gather", group, x, out, t0)
    return out


def reduce_scatter(c: torch.Tensor, group: Group) -> torch.Tensor:
    """``lax.psum_scatter(c, axes, scatter_dimension=0, tiled=True)``: the
    sum over the group of ``c``, of which this rank keeps row block
    ``group.me`` of ``group.size``."""
    if group.size == 1:
        return c
    import torch.distributed as dist

    q = group.size
    if c.shape[0] % q:
        raise ValueError(f"reduce_scatter: {c.shape[0]} rows do not split over {q} ranks")
    if _abstract(group):
        rows = c.shape[0] // q
        out = c[group.me * rows:(group.me + 1) * rows] * q
        _count("reduce-scatter", group, c, out, time.perf_counter())
        return out
    t0 = _start(c, group)
    src = _host(c, group)
    out = torch.empty((c.shape[0] // q,) + tuple(c.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.reduce_scatter(out, list(src.chunk(q, dim=0)), group=group.pg)
    out = _back(out, c)
    _count("reduce-scatter", group, c, out, t0)
    return out


def all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``lax.psum(x, axes)``: the sum over the group, as a new tensor."""
    if group.size == 1:
        return x
    if _abstract(group):
        out = x * group.size
        _count("all-reduce", group, x, out, time.perf_counter())
        return out
    import torch.distributed as dist

    t0 = _start(x, group)
    y = _host(x, group, copy=True)
    dist.all_reduce(y.reshape(-1), group=group.pg)  # a view: the sum lands in y
    out = _back(y, x)
    _count("all-reduce", group, x, out, t0)
    return out


def permute(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``lax.ppermute(x, axes, ring_perm(q))``: send ``x`` one hop
    downstream (to index ``me + 1``) and return what arrives from upstream
    (index ``me - 1``)."""
    q = group.size
    if q == 1:
        return x
    if _abstract(group):
        out = x.clone()
        _count("collective-permute", group, x, out, time.perf_counter())
        return out
    import torch.distributed as dist

    t0 = _start(x, group)
    src = _host(x, group)
    dst = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, group.ranks[(group.me + 1) % q], group.pg),
           dist.P2POp(dist.irecv, dst, group.ranks[(group.me - 1) % q], group.pg)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = _back(dst, x)
    _count("collective-permute", group, x, out, t0)
    return out
