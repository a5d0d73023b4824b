"""Training substrate: the train and serve step builders with microbatch
accumulation, their specs and sharded forms on a mesh (``train_state_specs``,
``batch_specs``, ``jit_train_step``, ``jit_serve_step``), and the
fault-tolerant loop. The port of ``repro.training``."""

from .loop import LoopConfig, TrainLoop
from .steps import (
    TrainState,
    batch_specs,
    build_serve_step,
    build_train_step,
    init_train_state,
    jit_serve_step,
    jit_train_step,
    train_state_specs,
)

__all__ = [
    "TrainState",
    "build_serve_step",
    "build_train_step",
    "init_train_state",
    "jit_serve_step",
    "jit_train_step",
    "train_state_specs",
    "batch_specs",
    "TrainLoop",
    "LoopConfig",
]
