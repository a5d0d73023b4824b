"""repro_torch: the PyTorch/CUDA port of ``repro`` (communication-optimal
MTTKRP and CP-ALS), for an NVIDIA H100.

It carries dense CP-ALS on the per-mode, fused (mode-reuse) and
dimension-tree schedules, every contraction through the hand-written
Hopper kernels (``backend="cuda"``)::

    import torch, repro_torch

    ctx = repro_torch.ExecutionContext.create(backend="cuda")   # device="cuda"
    x = torch.randn(200, 180, 160, device="cuda")
    cp = repro_torch.cp_als(x, rank=16, n_iters=10, sweep="fused", ctx=ctx)
    b0 = repro_torch.mttkrp(x, cp.factors, 0, ctx=ctx)

The JAX package ``repro`` is the reference; this package never imports it.
"""

from .core.cp_als import CPResult, cp_als
from .engine.context import ExecutionContext
from .engine.execute import contract_partial, mttkrp
from .engine.plan import BlockPlan, Memory

__all__ = [
    "ExecutionContext",
    "Memory",
    "BlockPlan",
    "mttkrp",
    "contract_partial",
    "cp_als",
    "CPResult",
]
