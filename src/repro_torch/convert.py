"""The bridge that carries parameters into the port: numpy arrays, and the
plan and memory dicts the reference writes (its tune cache's
``plan_to_dict`` and its context's ``memory`` entry). With these a caller
pins the same plan and the same initial factors on both sides.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .core.cp_als import CPResult
from .core.tucker import TuckerResult
from .engine.plan import BlockPlan, Memory, MultiTTMPlan


def tensor_from_numpy(
    array: np.ndarray, device: str | torch.device = "cuda", dtype: torch.dtype | None = None
) -> torch.Tensor:
    """A copy of ``array`` on ``device`` (in ``dtype``, default its own)."""
    return torch.from_numpy(np.array(array, copy=True)).to(device=device, dtype=dtype)


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
