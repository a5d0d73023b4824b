"""The bridge that carries parameters into the port: numpy arrays, the
plan and memory dicts the reference writes (its tune cache's
``plan_to_dict`` and its context's ``memory`` entry), the language
model's parameter pytree and its training state. With these a caller pins
the same plan, the same initial factors, the same weights and the same
optimizer state on both sides.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .core.cp_als import CPResult
from .core.tucker import TuckerResult
from .engine.plan import BlockPlan, Memory, MultiTTMPlan
from .models import set_trainable
from .models.attention import Attention
from .models.blocks import Layer
from .models.config import ArchConfig
from .models.layers import MLP, Embedding, Norm
from .models.model import LM
from .models.moe import MoE
from .models.ssm import SSM
from .optim import AdamWState
from .training import TrainState


def tensor_from_numpy(
    array: np.ndarray, device: str | torch.device = "cuda", dtype: torch.dtype | None = None
) -> torch.Tensor:
    """A copy of ``array`` on ``device`` (in ``dtype``, default its own; a
    bfloat16 array, which numpy holds as ``ml_dtypes.bfloat16``, stays
    bfloat16, exactly)."""
    a = np.asarray(array)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=dtype or torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=dtype)


def factors_from_numpy(
    arrays: Sequence[np.ndarray],
    device: str | torch.device = "cuda",
    dtype: torch.dtype | None = None,
) -> list[torch.Tensor]:
    """Factor matrices ``(I_k, R)`` on ``device``."""
    return [tensor_from_numpy(a, device, dtype) for a in arrays]


def cp_result_from_numpy(
    factors: Sequence[np.ndarray],
    weights: np.ndarray,
    fits: Sequence[float],
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype | None = None,
) -> CPResult:
    """A :class:`CPResult` from a reference result's arrays."""
    return CPResult(
        factors_from_numpy(factors, device, dtype),
        tensor_from_numpy(weights, device, dtype),
        [float(f) for f in fits],
    )


def block_plan_from_dict(d: Mapping) -> BlockPlan:
    """A :class:`BlockPlan` from the reference's plan dict
    (``repro.tune.cache.plan_to_dict``)."""
    if "ranks" in d:
        raise ValueError("a Multi-TTM plan: read it with multi_ttm_plan_from_dict")
    return BlockPlan(
        block_i=int(d["block_i"]),
        block_contract=tuple(int(c) for c in d["block_contract"]),
        block_r=int(d["block_r"]),
        x_has_rank=bool(d.get("x_has_rank", False)),
    )


def multi_ttm_plan_from_dict(d: Mapping) -> MultiTTMPlan:
    """A :class:`MultiTTMPlan` from the reference's plan dict
    (``repro.tune.cache.plan_to_dict`` of a ``MultiTTMPlan``)."""
    if "ranks" not in d:
        raise ValueError("an MTTKRP plan: read it with block_plan_from_dict")
    return MultiTTMPlan(
        block_i=int(d["block_i"]),
        block_contract=tuple(int(c) for c in d["block_contract"]),
        ranks=tuple(int(r) for r in d["ranks"]),
    )


def tucker_result_from_numpy(
    core: np.ndarray,
    factors: Sequence[np.ndarray],
    fits: Sequence[float],
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype | None = None,
) -> TuckerResult:
    """A :class:`TuckerResult` from a reference result's core and factors."""
    return TuckerResult(
        tensor_from_numpy(core, device, dtype),
        factors_from_numpy(factors, device, dtype),
        [float(f) for f in fits],
    )


def memory_from_dict(d: Mapping) -> Memory:
    """A :class:`Memory` from a context's ``memory`` entry (either package's)."""
    return Memory(
        budget_bytes=int(d["budget_bytes"]),
        lane=int(d.get("lane", 1)),
        sublane=int(d.get("sublane", 1)),
        itemsize=int(d.get("itemsize", 4)),
    )


def lm_from_numpy(
    params: Mapping,
    cfg: ArchConfig,
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype | None = None,
) -> LM:
    """The port's model from the reference's ``init_params`` pytree, given
    as numpy arrays (``jax.tree.map(np.asarray, params)``): ``blocks`` for
    a decoder-only model, ``encoder``, ``enc_norm`` and ``decoder`` (of
    ``cfg.dec_layers`` layers, each with ``norm_x`` and ``xattn``) for the
    encoder-decoder model. The reference stacks each period position's
    leaves over the layer groups (``params["blocks"][pos][...]`` has a
    leading ``n_groups`` axis); layer ``g * period + pos`` takes slice ``g``
    of position ``pos``: its ``norm1``, ``attn`` (``wq``, ``wk``, ``wv``,
    ``wo`` and, with ``qkv_bias``, ``bq``, ``bk``, ``bv``) or ``ssm``,
    ``norm_x`` and ``xattn`` where it has them, and ``norm2`` with ``mlp``
    (``wi``, ``wo`` and, gated, ``wg``) or ``moe`` (``router``, ``wi``,
    ``wo`` and, gated, ``wg``). ``dtype`` casts the leaves in the model's
    dtype; those the reference holds in fp32 whatever the model's dtype
    (the router; the SSM's ``A_log``, ``D``, ``dt_bias``) stay fp32."""

    def t(a, fp32: bool = False) -> torch.Tensor:
        return tensor_from_numpy(a, device, None if fp32 else dtype)

    parts = {"norm1": Norm, "attn": Attention, "ssm": SSM, "norm_x": Norm, "xattn": Attention,
             "norm2": Norm, "mlp": MLP, "moe": MoE}

    def stack(positions: Sequence[Mapping], n_layers: int) -> torch.nn.ModuleList:
        period = len(positions)
        n_groups = int(np.shape(positions[0]["norm1"]["scale"])[0])
        if period * n_groups != n_layers:
            raise ValueError(f"{period} positions x {n_groups} groups != {n_layers} layers")
        layers = []
        for layer in range(n_layers):
            g, pos = divmod(layer, period)
            tree = positions[pos]
            layers.append(Layer(**{name: parts[name]({k: t(v[g], k in parts[name].fp32)
                                                      for k, v in tree[name].items()})
                                   for name in tree}))
        return torch.nn.ModuleList(layers)

    def norm(tree: Mapping) -> Norm:
        return Norm({k: t(v) for k, v in tree.items()})

    embed = Embedding({k: t(v) for k, v in params["embed"].items()})
    if "blocks" in params:
        return LM(embed, norm(params["final_norm"]), stack(params["blocks"], cfg.n_layers))
    return LM(embed, norm(params["final_norm"]),
              encoder=stack(params["encoder"], cfg.n_layers), enc_norm=norm(params["enc_norm"]),
              decoder=stack(params["decoder"], cfg.dec_layers))


def train_state_from_numpy(
    state,
    cfg: ArchConfig,
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype | None = None,
) -> TrainState:
    """The port's :class:`~repro_torch.training.TrainState` from the
    reference's ``TrainState`` given as numpy arrays
    (``jax.tree.map(np.asarray, state)``): the parameters through
    :func:`lm_from_numpy` (in ``dtype``, every floating leaf trainable),
    the AdamW moments (and master copy, if kept) leaf for leaf in their
    own dtypes, keyed by the port's parameter names, and both steps."""

    def by_name(tree) -> dict[str, torch.Tensor]:
        return {k: p.detach() for k, p in lm_from_numpy(tree, cfg, device=device).named_parameters()}

    opt = state.opt
    params = set_trainable(lm_from_numpy(state.params, cfg, device=device, dtype=dtype))
    return TrainState(
        params=params,
        opt=AdamWState(step=tensor_from_numpy(opt.step, device), m=by_name(opt.m),
                       v=by_name(opt.v),
                       master=None if opt.master is None else by_name(opt.master)),
        step=tensor_from_numpy(state.step, device),
    )
