"""The train and serve step builders, the port of
``repro/training/steps.py``.

train_step(state, batch) -> (state, metrics)
  * the loss and its gradients (``torch.autograd.grad``) for each
    microbatch, added into ``accum_dtype`` buffers and divided by their
    count, as the reference's ``lax.scan`` over microbatches adds them;
  * the AdamW update (:func:`repro_torch.optim.adamw_update`), in place:
    the step consumes the state it is given, as the reference's jitted
    step donates it.

serve_step(params, decode_state, tokens) -> (logits, decode_state)
  one-token decode against the KV/SSM caches.

Both run eagerly (no ``torch.compile``), on the device the state is on.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..engine.context import check_device
from ..models import ArchConfig, decode_step, init_params, loss_fn, set_trainable
from ..models.model import LM
from ..optim import AdamWState, adamw_init, adamw_update
from ..optim.schedule import cosine_schedule


class TrainState(NamedTuple):
    params: LM
    opt: AdamWState
    step: torch.Tensor  # 0-dim int32


def init_train_state(cfg: ArchConfig, *, generator: torch.Generator, device="cuda",
                     moment_dtype: torch.dtype = torch.float32) -> TrainState:
    """The model drawn from ``generator`` on ``device`` (the card unless
    the caller asks for the CPU), every floating parameter trainable, and
    zeroed AdamW moments in ``moment_dtype``."""
    dev = check_device(device, "init_train_state")
    params = set_trainable(init_params(cfg, generator=generator, device=dev))
    return TrainState(params=params, opt=adamw_init(params, moment_dtype=moment_dtype),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def _split(batch: dict, microbatches: int) -> list[dict]:
    """``batch`` cut along its leading (batch) axis into ``microbatches``."""
    out = [{} for _ in range(microbatches)]
    for k, x in batch.items():
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"train_step: batch {b} of {k!r} is not a multiple of "
                             f"{microbatches} microbatches")
        for i, part in enumerate(x.reshape((microbatches, b // microbatches) + x.shape[1:])):
            out[i][k] = part
    return out


def build_train_step(
    cfg: ArchConfig,
    *,
    microbatches: int = 1,
    lr_fn: Callable | None = None,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
    accum_dtype: torch.dtype = torch.float32,
    opt_math_dtype: torch.dtype | None = None,
):
    """Returns train_step(state, batch) -> (state, metrics): ``loss`` (the
    mean over microbatches of :func:`repro_torch.models.loss_fn`), ``lr``,
    ``grad_norm`` and ``clip_scale``. With one microbatch the gradients
    are in the parameters' dtypes, as the reference's; with more, in
    ``accum_dtype``."""
    lr_fn = lr_fn if lr_fn is not None else (lambda s: cosine_schedule(s, 3e-4, 100, 10_000))

    def value_and_grad(state: TrainState, mb: dict) -> tuple[torch.Tensor, dict]:
        leaves = dict(state.params.named_parameters())
        frozen = sorted(k for k, p in leaves.items() if not p.requires_grad)
        if frozen:
            raise ValueError(f"train_step: parameters {frozen[:3]} ask for no gradient; build "
                             f"the state with init_train_state or set_trainable")
        loss, _ = loss_fn(state.params, cfg, mb)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                               for (k, p), g in zip(leaves.items(), grads)}

    def train_step(state: TrainState, batch: dict):
        if microbatches <= 1:
            loss, grads = value_and_grad(state, batch)
        else:
            grads, loss = None, torch.zeros((), dtype=torch.float32, device=state.step.device)
            for mb in _split(batch, microbatches):
                mb_loss, g = value_and_grad(state, mb)
                if grads is None:
                    grads = {k: torch.zeros(t.shape, dtype=accum_dtype, device=t.device)
                             for k, t in g.items()}
                for k, t in g.items():
                    grads[k].add_(t.to(accum_dtype))
                loss = loss + mb_loss
                del g
            grads = {k: t / microbatches for k, t in grads.items()}
            loss = loss / microbatches
        lr = lr_fn(state.step)
        params, opt, opt_metrics = adamw_update(
            state.params, grads, state.opt, lr,
            weight_decay=weight_decay, clip_norm=clip_norm, math_dtype=opt_math_dtype,
        )
        metrics = {"loss": loss, "lr": lr, **opt_metrics}
        return TrainState(params, opt, state.step + 1), metrics

    return train_step


def build_serve_step(cfg: ArchConfig):
    """Returns serve_step(params, state, tokens) -> (logits, state)."""

    def serve_step(params: LM, state: dict, tokens: torch.Tensor):
        return decode_step(params, cfg, state, tokens)

    return serve_step
