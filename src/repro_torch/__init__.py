"""repro_torch: the PyTorch/CUDA port of ``repro`` (communication-optimal
MTTKRP, CP-ALS and Tucker/HOOI), for an NVIDIA H100.

It carries dense CP-ALS on the per-mode, fused (mode-reuse) and
dimension-tree schedules, gradient-based CP, and Multi-TTM with
Tucker/HOOI, every contraction through the hand-written Hopper kernels
(``backend="cuda"``), and the batched forms of all of them: a leading batch
axis of B same-shaped tensors is one kernel launch a contraction::

    import torch, repro_torch

    ctx = repro_torch.ExecutionContext.create(backend="cuda")   # device="cuda"
    x = torch.randn(200, 180, 160, device="cuda")
    cp = repro_torch.cp_als(x, rank=16, n_iters=10, sweep="fused", ctx=ctx)
    b0 = repro_torch.mttkrp(x, cp.factors, 0, ctx=ctx)
    tk = repro_torch.tucker_hooi(x, (16, 12, 8), n_iters=5, ctx=ctx)
    y0 = repro_torch.multi_ttm(x, tk.factors, keep=0, ctx=ctx)
    xs = torch.randn(16, 96, 96, 96, device="cuda")              # a batch of 16
    cps = repro_torch.cp_als_batched(xs, rank=16, n_iters=10, ctx=ctx)

``backend="auto"`` resolves each contraction through the tune cache
(:mod:`repro_torch.tune`), and :class:`~repro_torch.launch.serve.
DecompositionServer` buckets CP requests into batched runs::

    from repro_torch.launch.serve import DecompositionServer

    server = DecompositionServer(repro_torch.ExecutionContext.create("auto"))
    server.submit(torch.randn(90, 95, 93, device="cuda"), rank=16)
    results = server.flush()

:class:`Trace` records a span event for every engine dispatch, driver
iteration and served request inside it (``python -m
repro_torch.observe.report TRACE.jsonl`` tables them)::

    with repro_torch.Trace(path="run.jsonl"):
        repro_torch.cp_als(x, rank=16, ctx=ctx)

A distributed context runs the stationary-tensor CP and Tucker/HOOI
sweeps on an initialized ``torch.distributed`` group, every rank calling
with the whole tensor and cutting its own block
(:mod:`repro_torch.distributed`)::

    ctx = repro_torch.ExecutionContext.create("cuda", distributed=True)
    cp = repro_torch.cp_als(x, rank=16, n_iters=10, ctx=ctx)   # on every rank
    tk = repro_torch.tucker_hooi(x, (16, 12, 8), n_iters=5, ctx=ctx)

The JAX package ``repro`` is the reference; this package never imports it.
"""

from .core.cp_als import CPResult, cp_als, cp_gradient
from .core.tucker import TuckerResult, tucker_hooi
from .engine.batch import (
    BatchedCPResult,
    BatchedTuckerResult,
    cp_als_batched,
    tucker_hooi_batched,
)
from .distributed.grid_select import select_grid, select_tucker_grid
from .engine.context import Distribution, ExecutionContext
from .engine.execute import contract_partial, mttkrp, multi_ttm
from .engine.plan import BlockPlan, Memory, MultiTTMPlan
from .observe.trace import Trace

__all__ = [
    "ExecutionContext",
    "Distribution",
    "select_grid",
    "select_tucker_grid",
    "Memory",
    "BlockPlan",
    "mttkrp",
    "contract_partial",
    "cp_als",
    "cp_gradient",
    "CPResult",
    "cp_als_batched",
    "BatchedCPResult",
    "multi_ttm",
    "MultiTTMPlan",
    "tucker_hooi",
    "TuckerResult",
    "tucker_hooi_batched",
    "BatchedTuckerResult",
    "Trace",
]
