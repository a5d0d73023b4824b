"""Optimizer substrate: AdamW with fp32 (or bf16) moments, global-norm
clipping, LR schedules. The port of ``repro.optim``; ``opt_state_specs``
waits for the mesh layer (ROADMAP Queue 1 item 15f)."""

from .adamw import AdamWState, adamw_init, adamw_update
from .schedule import cosine_schedule, linear_warmup

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "linear_warmup",
]
