"""The optimality-ratio auditor: measured bytes against the model and the
lower bound. Counterpart of ``repro.observe.bounds_audit``.

The paper's claim is a triple: what a blocked MTTKRP moves, what the Eq
(10) blocked model says it should move, and what Theorem 4.1 says it must
move. For one engine call this module emits one :class:`AuditRow`:

    measured_bytes    — the bytes every operation the call ran reads and
                        writes at its boundary, summed (``op_boundaries``)
    modeled_words     — ``BlockPlan.eq10_words`` (Eq 10) /
                        ``MultiTTMPlan.model_words``
    lower_bound_words — ``seq_lb_memory`` (Thm 4.1) /
                        ``multi_ttm_seq_lb_memory``, clamped at 0

with the two ratios that summarize them (``measured / modeled``: how far
the run is above the model; ``modeled / bound``: how close to optimal the
schedule is). Model and bound are the reference's formulas against
``ctx.memory``, or ``Memory.h100_smem`` when the context carries none.

The measured side. The reference counts the fusion-boundary bytes of the
compiled HLO. The port has no HLO; it counts what each operation the call
ran reads and writes, once, at its boundary:

* aten operations, through a ``TorchDispatchMode`` held around the call: a
  view (an output that shares its input's storage) moves nothing, a copy
  such as ``.contiguous()`` reads its input and writes its output, an
  allocation (``empty``) moves nothing;
* the Hopper kernels, which ``ctypes`` launches past the dispatcher,
  through their wrappers' reports (:mod:`.collect`): each launch's
  operands and result, a split-K workspace included.

On a CPU tensor the wrappers report the launches the card would make and
their plain versions' own operations are not counted, so the count is the
same on the CPU and on the card. Rows are recorded into the active
:class:`~.trace.Trace` (kind ``"bounds_audit"``, ``measured_by:
"op_boundaries"``).
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from . import collect
from .trace import record_event

MEASURED_BY = "op_boundaries"


@dataclass(frozen=True)
class AuditRow:
    """One dispatch's measured / modeled / lower-bound triple (bytes are
    counted at operation boundaries; words are dtype-free model counts)."""

    name: str
    itemsize: int
    measured_bytes: float
    modeled_words: float
    lower_bound_words: float
    measured_by: str = MEASURED_BY

    @property
    def modeled_bytes(self) -> float:
        return self.modeled_words * self.itemsize

    @property
    def lower_bound_bytes(self) -> float:
        return self.lower_bound_words * self.itemsize

    @property
    def measured_over_model(self) -> float | None:
        """How far above the blocked model the run is (1.0 = the model is
        exact; None when the model is degenerate)."""
        if self.modeled_bytes <= 0:
            return None
        return self.measured_bytes / self.modeled_bytes

    @property
    def model_over_bound(self) -> float | None:
        """The optimality ratio: modeled traffic over the Thm-4.1 floor
        (None when the bound clamps to 0)."""
        if self.lower_bound_bytes <= 0:
            return None
        return self.modeled_bytes / self.lower_bound_bytes

    def to_dict(self) -> dict:
        d = asdict(self)
        d["modeled_bytes"] = self.modeled_bytes
        d["lower_bound_bytes"] = self.lower_bound_bytes
        d["measured_over_model"] = self.measured_over_model
        d["model_over_bound"] = self.model_over_bound
        return d


#: Allocations: an output nothing has written yet.
_ALLOCS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                     "new_empty_strided"})


def _elem_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` addresses (a broadcast axis, stride 0,
    counts once)."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0) if t.ndim else 1
    return n * t.element_size() if t.numel() else 0


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one aten operation moves at its boundary: its tensor inputs
    read once and its outputs written once; 0 for a view (every output
    shares storage with an input) and for an allocation. An in-place or
    ``out=`` operation writes the tensors it mutates; ``copy_`` does not
    read its destination."""
    if func.overloadpacket.__name__ in _ALLOCS:
        return 0
    ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    schema = func._schema
    if not schema.is_mutable:
        storages = {t.untyped_storage().data_ptr() for t in ins}
        if outs and all(o.untyped_storage().data_ptr() in storages for o in outs):
            return 0
        return sum(map(_elem_bytes, ins)) + sum(map(_elem_bytes, outs))
    written = []
    for i, a in enumerate(schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        if isinstance(v, torch.Tensor):
            written.append(v)
    skip = {id(t) for t in written} if func.overloadpacket.__name__ == "copy_" \
        or "out" in kwargs else set()
    return (sum(_elem_bytes(t) for t in ins if id(t) not in skip)
            + sum(map(_elem_bytes, written)))


class OpBoundaries(TorchDispatchMode):
    """Counts the bytes at every operation boundary inside the block: aten
    operations through this dispatch mode, kernel launches through their
    wrappers' reports. ``ops`` lists the aten operations counted, in order."""

    def __init__(self) -> None:
        super().__init__()
        self.aten_bytes = 0
        self.ops: list[str] = []
        self.kernels: list[collect.Launch] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not collect.is_quiet():
            self.aten_bytes += op_bytes(func, args, kwargs, out)
            self.ops.append(str(func))
        return out

    def __enter__(self):
        collect.SINKS.append(self.kernels)
        return super().__enter__()

    def __exit__(self, *exc):
        collect.detach(self.kernels)
        return super().__exit__(*exc)

    @property
    def kernel_bytes(self) -> int:
        return sum(k.nbytes for k in self.kernels)

    @property
    def nbytes(self) -> int:
        return self.aten_bytes + self.kernel_bytes


def _audit(call, *, name: str, itemsize: int, modeled_words: float,
           lower_bound_words: float) -> AuditRow:
    """Run ``call`` once under an :class:`OpBoundaries` count and build
    (and record) the row. ``measured_collective_bytes`` is what the
    collective wrappers counted during the call
    (:mod:`repro_torch.distributed.collectives`; 0 on one device)."""
    from ..distributed.collectives import COUNTER, ring_total  # call-time: layer cycle

    before = COUNTER.snapshot()
    with OpBoundaries() as counted:
        call()
    collective = ring_total(COUNTER.delta(before))
    row = AuditRow(name=name, itemsize=int(itemsize), measured_bytes=float(counted.nbytes),
                   modeled_words=float(modeled_words),
                   lower_bound_words=float(lower_bound_words))
    record_event(
        "bounds_audit",
        name=name,
        itemsize=row.itemsize,
        measured_bytes=row.measured_bytes,
        modeled_words=row.modeled_words,
        lower_bound_words=row.lower_bound_words,
        measured_over_model=row.measured_over_model,
        model_over_bound=row.model_over_bound,
        measured_by=row.measured_by,
        aten_bytes=float(counted.aten_bytes),
        kernel_bytes=float(counted.kernel_bytes),
        measured_collective_bytes=float(collective),
    )
    return row


def _memory(ctx, itemsize: int):
    from ..engine.plan import Memory

    return ctx.memory or Memory.h100_smem(itemsize=itemsize)


def audit_mttkrp(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    *,
    ctx=None,
) -> AuditRow:
    """Run ``mttkrp(x, factors, mode, ctx=ctx)`` once and audit it: the
    bytes at its operation boundaries against the Eq-10 blocked model and
    the Thm-4.1 memory-dependent lower bound, both against ``ctx.memory``
    (default ``Memory.h100_smem``)."""
    from ..core.bounds import seq_lb_memory
    from ..engine.context import ExecutionContext
    from ..engine.execute import mttkrp
    from ..engine.plan import choose_blocks, keep_first

    if ctx is None:
        ctx = ExecutionContext.default()
    rank = next(int(f.shape[1]) for k, f in enumerate(factors) if k != mode)
    itemsize = x.element_size()
    mem = _memory(ctx, itemsize)
    canon = keep_first(x.shape, mode)
    plan = choose_blocks(canon, rank, itemsize, memory=mem)
    return _audit(
        lambda: mttkrp(x, factors, mode, ctx=ctx),
        name=f"mttkrp[shape={tuple(x.shape)},rank={rank},mode={mode}]",
        itemsize=itemsize,
        modeled_words=plan.eq10_words(canon, rank),
        lower_bound_words=max(seq_lb_memory(tuple(x.shape), rank, mem.budget_words), 0.0),
    )


def audit_multi_ttm(
    x: torch.Tensor,
    matrices: Sequence[torch.Tensor | None],
    keep: int | None = None,
    *,
    ctx=None,
) -> AuditRow:
    """The Multi-TTM counterpart of :func:`audit_mttkrp`: measured bytes
    against ``MultiTTMPlan.model_words`` and ``multi_ttm_seq_lb_memory``."""
    from ..core.bounds import multi_ttm_seq_lb_memory
    from ..engine.context import ExecutionContext
    from ..engine.execute import multi_ttm
    from ..engine.plan import choose_multi_ttm_blocks, keep_first

    if ctx is None:
        ctx = ExecutionContext.default()
    ranks = tuple(int(m.shape[1]) for k, m in enumerate(matrices) if k != keep)
    itemsize = x.element_size()
    mem = _memory(ctx, itemsize)
    canon = keep_first(x.shape, 0 if keep is None else keep)
    plan = choose_multi_ttm_blocks(canon, ranks[1:] if keep is None else ranks, itemsize,
                                   memory=mem)
    mats = [None if k == keep else m for k, m in enumerate(matrices)]
    return _audit(
        lambda: multi_ttm(x, mats, keep, ctx=ctx),
        name=f"multi_ttm[shape={tuple(x.shape)},ranks={ranks},keep={keep}]",
        itemsize=itemsize,
        modeled_words=plan.model_words(canon),
        lower_bound_words=max(
            multi_ttm_seq_lb_memory(tuple(x.shape), ranks, mem.budget_words), 0.0),
    )
