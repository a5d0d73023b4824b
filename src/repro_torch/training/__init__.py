"""Training substrate: the train and serve step builders with microbatch
accumulation, and the fault-tolerant loop. The port of ``repro.training``;
``train_state_specs``, ``batch_specs`` and the ``jit_*_step`` wiring wait
for the mesh layer (ROADMAP Queue 1 item 15f)."""

from .loop import LoopConfig, TrainLoop
from .steps import TrainState, build_serve_step, build_train_step, init_train_state

__all__ = [
    "TrainState",
    "build_serve_step",
    "build_train_step",
    "init_train_state",
    "TrainLoop",
    "LoopConfig",
]
