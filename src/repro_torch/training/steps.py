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
``jit_train_step`` and ``jit_serve_step`` are the sharded steps, the
reference's jitted ones with ``in_shardings``/``out_shardings``: under a
mesh they lay the state and the batch out by their spec trees
(:func:`train_state_specs`, :func:`batch_specs`,
:func:`repro_torch.models.cache_specs`), run on DTensors, and return the
state laid out the same; the in-place update is the reference's donation.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..engine.context import check_device
from ..models import ArchConfig, decode_step, init_params, loss_fn, set_trainable
from ..models.model import LM, cache_specs, param_specs
from ..models.sharding import NULL, Sharding, distribute_tree, full, replicating
from ..optim import AdamWState, adamw_init, adamw_update, opt_state_specs
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


def train_state_specs(state: TrainState, cfg: ArchConfig, sh: Sharding) -> TrainState:
    pspecs = param_specs(state.params, cfg, sh)
    return TrainState(params=pspecs, opt=opt_state_specs(pspecs), step=())


def batch_specs(cfg: ArchConfig, sh: Sharding) -> dict:
    """Global batches are sharded over DP on the batch dim."""
    spec2 = sh.spec("dp", None)
    spec3 = sh.spec("dp", None, None)
    out = {}
    if cfg.frontend != "none":
        out["embeds"] = spec3
    else:
        out["tokens"] = spec2
    if cfg.is_encdec:
        out["dec_tokens"] = spec2
        out["dec_labels"] = spec2
    else:
        out["labels"] = spec2
    return out


def _split(batch: dict, microbatches: int, sh: Sharding) -> list[dict]:
    """``batch`` cut along its leading (batch) axis into ``microbatches``,
    each part laid out over dp as the batch is (:func:`_microbatch`)."""
    out = [{} for _ in range(microbatches)]
    for k, x in batch.items():
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"train_step: batch {b} of {k!r} is not a multiple of "
                             f"{microbatches} microbatches")
        n = b // microbatches
        for i in range(microbatches):
            out[i][k] = _microbatch(x, i * n, n, sh)
    return out


def _microbatch(x: torch.Tensor, start: int, n: int, sh: Sharding) -> torch.Tensor:
    """Rows ``[start, start + n)`` of ``x``, laid out over dp. A slice of a
    batch split over dp crosses its shards, and DTensor would gather the
    whole batch onto every rank to cut it; here each rank writes the rows
    it holds at their places in zeros, and one reduce-scatter over the
    ranks that split the batch lays this part alone out over dp (an exact
    sum: each row is written on one rank)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    spec = sh.spec("dp", *(None,) * (x.dim() - 1))
    dims = tuple(d for d, p in enumerate(getattr(x, "placements", ())) if p.is_shard(0))
    if not isinstance(x, DTensor) or not dims:
        return sh.place(x[start:start + n], spec)
    local = x.to_local()
    first = sh.shard_index(dims) * local.shape[0]
    lo, hi = max(start, first), min(start + n, first + local.shape[0])
    part = local.new_zeros((n,) + tuple(local.shape[1:]))
    if lo < hi:
        part[lo - start:hi - start] = local[lo - first:hi - first]
    pending = tuple(Partial() if d in dims else Replicate() for d in range(sh.mesh.ndim))
    return sh.place(DTensor.from_local(part, sh.mesh, pending, run_check=False), spec)


def build_train_step(
    cfg: ArchConfig,
    *,
    sh: Sharding = NULL,
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
    ``accum_dtype``. Under a mesh (``sh``) the state and the batch are
    DTensors laid out by their specs (:func:`jit_train_step` lays them
    out), each gradient is laid out as its parameter, and the step runs
    inside :func:`~repro_torch.models.sharding.replicating`."""
    lr_fn = lr_fn if lr_fn is not None else (lambda s: cosine_schedule(s, 3e-4, 100, 10_000))

    def value_and_grad(state: TrainState, mb: dict) -> tuple[torch.Tensor, dict]:
        leaves = dict(state.params.named_parameters())
        frozen = sorted(k for k, p in leaves.items() if not p.requires_grad)
        if frozen:
            raise ValueError(f"train_step: parameters {frozen[:3]} ask for no gradient; build "
                             f"the state with init_train_state or set_trainable")
        loss, _ = loss_fn(state.params, cfg, mb, sh=sh)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(p) if g is None else _like(g, p)
                               for (k, p), g in zip(leaves.items(), grads)}

    def train_step(state: TrainState, batch: dict):
        with replicating(sh):
            return step_body(state, batch)

    def step_body(state: TrainState, batch: dict):
        if microbatches <= 1:
            loss, grads = value_and_grad(state, batch)
        else:
            grads, loss = None, torch.zeros((), dtype=torch.float32, device=state.step.device)
            for mb in _split(batch, microbatches, sh):
                mb_loss, g = value_and_grad(state, mb)
                if grads is None:
                    grads = {k: torch.zeros_like(t, dtype=accum_dtype) for k, t in g.items()}
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


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The gradient ``g`` laid out as its parameter ``p`` (a DTensor's
    gradient may come back partial or otherwise laid out)."""
    from torch.distributed.tensor import DTensor

    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def build_serve_step(cfg: ArchConfig, *, sh: Sharding = NULL):
    """Returns serve_step(params, state, tokens, cross_kv=None) -> (logits,
    state); ``cross_kv`` is an encoder-decoder model's encoder K/V."""

    def serve_step(params: LM, state: dict, tokens: torch.Tensor, cross_kv=None):
        return decode_step(params, cfg, state, tokens, cross_kv, sh=sh)

    return serve_step


# --------------------------------------------------------------------------
# the sharded steps (layouts attached)
# --------------------------------------------------------------------------

def jit_train_step(cfg: ArchConfig, sh: Sharding, state: TrainState, microbatches: int = 1,
                   accum_dtype: torch.dtype = torch.float32, **kw):
    """The train step with its layouts, the reference's ``jit_train_step``
    (no ``torch.compile``: it runs eagerly). Without a mesh, the plain
    :func:`build_train_step`. Under one, ``step(state, batch)`` lays the
    state out by :func:`train_state_specs` (a state already laid out is
    kept, so from the second step on nothing moves) and the batch by
    :func:`batch_specs`, steps on DTensors in place, and returns the state
    laid out the same, with metrics as whole values (``full``). ``kw``
    goes to :func:`build_train_step` (``lr_fn``, ...)."""
    step = build_train_step(cfg, sh=sh, microbatches=microbatches, accum_dtype=accum_dtype, **kw)
    if sh.mesh is None:
        return step
    sspecs = train_state_specs(state, cfg, sh)
    bspecs = batch_specs(cfg, sh)

    def sharded_step(state: TrainState, batch: dict):
        state = distribute_tree(state, sspecs, sh)
        new, metrics = step(state, distribute_tree(batch, bspecs, sh))
        return new, {k: full(v) for k, v in metrics.items()}

    return sharded_step


def jit_serve_step(cfg: ArchConfig, sh: Sharding, params: LM, decode_state: dict):
    """The serve step with its layouts, the reference's ``jit_serve_step``.
    Without a mesh, the plain :func:`build_serve_step`. Under one,
    ``step(params, state, tokens, cross_kv=None)`` lays the parameters out
    by :func:`~repro_torch.models.param_specs`, the caches by
    :func:`~repro_torch.models.cache_specs`, the tokens over dp and an
    encoder's K/V over dp and sp (the reference's dry run lays them so), and
    returns the logits as a DTensor and the state laid out by the cache
    specs."""
    step = build_serve_step(cfg, sh=sh)
    if sh.mesh is None:
        return step
    pspecs = param_specs(params, cfg, sh)
    cspecs = cache_specs(decode_state, cfg, sh)

    def sharded_step(params: LM, state: dict, tokens: torch.Tensor, cross_kv=None):
        if cross_kv is not None:
            cross_kv = tuple(sh.constrain(t, "dp", "sp", None, None) for t in cross_kv)
        logits, new = step(distribute_tree(params, pspecs, sh),
                           distribute_tree(state, cspecs, sh),
                           sh.constrain(tokens, "dp", None), cross_kv)
        return logits, distribute_tree(new, cspecs, sh)

    return sharded_step
