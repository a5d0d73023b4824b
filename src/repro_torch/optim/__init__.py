"""Optimizer substrate: AdamW with fp32 (or bf16) moments, global-norm
clipping, LR schedules, and the moments' specs under a mesh
(``opt_state_specs``). The port of ``repro.optim``."""

from .adamw import AdamWState, adamw_init, adamw_update, opt_state_specs
from .schedule import cosine_schedule, linear_warmup

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "linear_warmup",
    "opt_state_specs",
]
