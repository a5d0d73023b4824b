"""Planner, execution context and dispatch.

The package exports the planner's and the context's public names, as
``repro.engine`` does; the dispatch layer is ``repro_torch.engine.execute``
(and ``repro_torch.mttkrp`` etc.), imported on its own because it pulls in
the kernel wrappers, which import the planner.
"""

from .context import (
    VALID_BACKENDS,
    ExecutionContext,
    PlanDecision,
    ProblemSpec,
    check_backend,
)
from .plan import (
    LANE,
    SUBLANE,
    VMEM_BUDGET,
    VMEM_BYTES,
    BlockPlan,
    Memory,
    MultiTTMPlan,
    best_uniform_block,
    choose_blocks,
    choose_multi_ttm_blocks,
    mttkrp_traffic_model,
    uniform_block_feasible,
    uniform_multi_ttm_plan,
)

__all__ = [
    "VALID_BACKENDS",
    "ExecutionContext",
    "PlanDecision",
    "ProblemSpec",
    "check_backend",
    "LANE",
    "SUBLANE",
    "VMEM_BUDGET",
    "VMEM_BYTES",
    "BlockPlan",
    "Memory",
    "MultiTTMPlan",
    "best_uniform_block",
    "choose_blocks",
    "choose_multi_ttm_blocks",
    "mttkrp_traffic_model",
    "uniform_block_feasible",
    "uniform_multi_ttm_plan",
]
