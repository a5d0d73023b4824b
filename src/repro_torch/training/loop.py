"""Fault-tolerant training loop, the port of ``repro/training/loop.py``,
line for line:

  * resume-from-latest on start (laid out on ``mesh`` by ``spec_tree``
    where given: the elastic restore);
  * periodic async checkpointing (overlapped with training);
  * failure handling: a step that raises is retried from the last
    checkpoint up to ``max_restarts`` times (on real fleets the launcher
    restarts the process; this loop implements the same state machine
    in-process so it is testable);
  * straggler monitor: per-step wall-time EMA; steps slower than
    ``straggler_factor`` x the EMA are counted and surfaced in the stats.

The reference's quirks are kept: a restart with no checkpoint yet keeps
the current state (which the in-place step has already advanced) and
sets the step to 0, and the non-finite-loss check comes after the state
is replaced.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..checkpoint import CheckpointManager
from ..data import DataConfig, synthetic_batch


@dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = field(default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                                               "repro_torch_ckpt"))
    keep: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


@dataclass
class LoopStats:
    steps_done: int = 0
    restarts: int = 0
    stragglers: int = 0
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)


class TrainLoop:
    def __init__(
        self,
        step_fn: Callable,          # (state, batch) -> (state, metrics)
        data_cfg: DataConfig,
        loop_cfg: LoopConfig,
        batch_fn: Callable | None = None,
        place_batch: Callable | None = None,
    ):
        self.step_fn = step_fn
        self.data_cfg = data_cfg
        self.cfg = loop_cfg
        self.batch_fn = batch_fn or synthetic_batch
        self.place_batch = place_batch or (lambda b: b)
        self.ckpt = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep)
        self.stats = LoopStats()

    def run(self, state, mesh=None, spec_tree=None, fail_injector: Callable | None = None):
        """Run to total_steps with restart-on-failure. `fail_injector(step)`
        raising simulates node failures (used by tests). Every restore lays
        the state out on ``mesh`` by ``spec_tree`` where given."""
        cfg = self.cfg
        start, restored = self.ckpt.restore_latest(state, mesh=mesh, spec_tree=spec_tree)
        if restored is not None:
            state = restored
            step = start
        else:
            step = 0
        ema = None
        while step < cfg.total_steps:
            try:
                batch = self.place_batch(self.batch_fn(self.data_cfg, step))
                t0 = time.perf_counter()
                if fail_injector is not None:
                    fail_injector(step)
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step}")
                dt = time.perf_counter() - t0
                ema = dt if ema is None else 0.9 * ema + 0.1 * dt
                if dt > self.cfg.straggler_factor * ema:
                    self.stats.stragglers += 1
                self.stats.losses.append(loss)
                self.stats.step_times.append(dt)
                step += 1
                self.stats.steps_done += 1
                if step % cfg.ckpt_every == 0 or step == cfg.total_steps:
                    self.ckpt.save_async(step, state)
            except Exception:
                self.stats.restarts += 1
                if self.stats.restarts > cfg.max_restarts:
                    raise
                self.ckpt.wait()
                restored_step, restored = self.ckpt.restore_latest(
                    state, mesh=mesh, spec_tree=spec_tree
                )
                if restored is None:
                    step = 0  # no checkpoint yet: restart from scratch
                else:
                    state, step = restored, restored_step
        self.ckpt.wait()
        return state, self.stats
