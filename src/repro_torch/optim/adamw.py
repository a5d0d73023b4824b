"""AdamW, hand-rolled: the port of ``repro/optim/adamw.py``, with its math.

Moments are fp32 (``moment_dtype=torch.bfloat16`` halves them). A bf16
parameter is updated through an fp32 side computation from its own value
(no master copy: the update runs in fp32 from the fp32 moments and the
bf16 parameter is re-rounded); ``keep_master=True`` keeps an fp32 master.

The update works in place, as the reference's jitted step donates its
state (``donate_argnums=(0,)``): at Mamba2-2.7b's 2.70 G parameters a
functional update would hold two 32 GB states at once. It reads every
gradient and takes the global norm before it writes anything, and it
consumes the state it is given (``docs/PORT.md``). Under a mesh the
parameters, gradients and moments are DTensors; each moment keeps its
parameter's spec (:func:`opt_state_specs`), and the in-place update keeps
every placement.
"""

from __future__ import annotations

from typing import Iterable, Mapping, NamedTuple

import torch
from torch import nn


class AdamWState(NamedTuple):
    step: torch.Tensor                         # 0-dim int32, the updates taken
    m: dict[str, torch.Tensor]                 # like the parameters, by name
    v: dict[str, torch.Tensor]
    master: dict[str, torch.Tensor] | None     # fp32 parameters, or None


def named_leaves(params: nn.Module | Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The tensors an update takes, by name: a module's named parameters,
    or a mapping's items."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params: nn.Module | Mapping[str, torch.Tensor], keep_master: bool = False,
               moment_dtype: torch.dtype = torch.float32) -> AdamWState:
    """Zeroed moments in ``moment_dtype`` (bf16 halves optimizer memory,
    the reference's choice for the >= 300B archs) beside each parameter,
    and with ``keep_master`` an fp32 copy of each."""
    leaves = named_leaves(params)
    device = next(iter(leaves.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m={k: torch.zeros(p.shape, dtype=moment_dtype, device=p.device) for k, p in leaves.items()},
        v={k: torch.zeros(p.shape, dtype=moment_dtype, device=p.device) for k, p in leaves.items()},
        master=({k: p.detach().to(torch.float32, copy=True) for k, p in leaves.items()}
                if keep_master else None),
    )


def global_norm(grads: Iterable[torch.Tensor] | Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of the fp32 sum of squares."""
    gs = grads.values() if isinstance(grads, Mapping) else grads
    return torch.sqrt(sum(g.float().square().sum() for g in gs))


@torch.no_grad()
def adamw_update(params: nn.Module | Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                 state: AdamWState, lr: torch.Tensor | float, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1, clip_norm: float = 1.0,
                 math_dtype: torch.dtype | None = None):
    """Returns (params, new_state, metrics), ``params`` and the moments
    updated in place. ``grads`` holds a gradient for every parameter, by
    name. ``math_dtype``: the update's arithmetic (default fp32; bf16
    halves the temporaries, the reference's choice for the >= 300B
    archs). Metrics: ``grad_norm`` (before clipping) and ``clip_scale``."""
    leaves = named_leaves(params)
    if set(grads) != set(leaves):
        raise ValueError(f"adamw_update: gradients for {sorted(set(grads) ^ set(leaves))} "
                         f"missing or unexpected")
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = (clip_norm / gnorm.clamp_min(1e-12)).clamp_max(1.0)
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())
    mdt = math_dtype or torch.float32
    for k, p in leaves.items():
        m, v = state.m[k], state.v[k]
        master = state.master[k] if state.master is not None else None
        g = grads[k].to(mdt) * scale.to(mdt)
        m_new = b1 * m.to(mdt) + (1 - b1) * g
        v_new = b2 * v.to(mdt) + (1 - b2) * g.square()
        mh = m_new.float() / c1
        vh = v_new.float() / c2
        if mdt == torch.float32:
            base = master if master is not None else p.float()
        else:
            base = p.to(mdt)
        delta = (mh / (vh.sqrt() + eps)).to(mdt) + (weight_decay * base).to(mdt)
        # an fp32 lr multiplies in fp32, as a jnp array does in the reference
        step_size = lr * delta.float() if isinstance(lr, torch.Tensor) else lr * delta
        new_master = base.to(mdt) - step_size.to(mdt)
        p.copy_(new_master)
        m.copy_(m_new)
        v.copy_(v_new)
        if master is not None:
            master.copy_(new_master)
    metrics = {"grad_norm": gnorm, "clip_scale": scale}
    return params, AdamWState(step, state.m, state.v, state.master), metrics


def opt_state_specs(param_spec_tree: Mapping, keep_master: bool = False) -> AdamWState:
    """Moments inherit the param specs (fully sharded, ZeRO-style); the
    step is replicated."""
    return AdamWState(
        step=(),
        m=dict(param_spec_tree),
        v=dict(param_spec_tree),
        master=dict(param_spec_tree) if keep_master else None,
    )
