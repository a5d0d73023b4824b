"""Algorithm 2 (sequential blocked MTTKRP) and the blocked Multi-TTM as
host-level einsums (PyTorch).

Counterpart of ``repro.core.blocked.mttkrp_blocked`` and
``multi_ttm_blocked``: the tensor is cut into ``b x ... x b`` blocks whose
coordinates become explicit contraction indices, so the contraction follows
the paper's blocked loop order. The mid-level oracle for the kernels.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from .mttkrp import mttkrp

_L = "abcdefghijklmnop"


def _pad_rows(x: torch.Tensor, block: int) -> torch.Tensor:
    """Zero-pad every axis of ``x`` up to a multiple of ``block``."""
    pads: list[int] = []
    for d in reversed(x.shape):
        pads += [0, (-d) % block]
    return F.pad(x, pads) if any(pads) else x


def mttkrp_blocked(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor | None],
    mode: int,
    block: int,
    f32_acc: bool = False,
) -> torch.Tensor:
    """Blocked MTTKRP with Algorithm 2's loop order, expressed as einsum:

        B[n_blk, n_in, r] += X[blk..., in...] * prod_k A_k[k_blk, k_in, r]

    ``f32_acc=True`` forces fp32 accumulation (the engine sets it whenever a
    ``compute_dtype`` policy casts the operands to a narrow type): the
    operands are widened to float32, which is exact, and the result is
    float32.
    """
    n = x.ndim
    dims = x.shape
    rank = next(f.shape[1] for k, f in enumerate(factors) if k != mode)
    if f32_acc:
        x = x.float()
    xp = _pad_rows(x, block)
    newshape: list[int] = []
    for d in xp.shape:
        newshape += [d // block, block]
    xb = xp.reshape(newshape)
    t_sub = "".join(_L[2 * k] + _L[2 * k + 1] for k in range(n))
    f_subs, f_ops = [], []
    for k in range(n):
        if k == mode:
            continue
        fk = factors[k]
        if f32_acc:
            fk = fk.float()
        fp = F.pad(fk, (0, 0, 0, (-fk.shape[0]) % block))
        f_ops.append(fp.reshape(fp.shape[0] // block, block, rank))
        f_subs.append(_L[2 * k] + _L[2 * k + 1] + "z")
    out_sub = _L[2 * mode] + _L[2 * mode + 1] + "z"
    spec = ",".join([t_sub] + f_subs) + "->" + out_sub
    out = torch.einsum(spec, xb, *f_ops).reshape(-1, rank)
    return out[: dims[mode], :]


def multi_ttm_blocked(
    x: torch.Tensor,
    matrices: Sequence[torch.Tensor | None],
    keep: int | None,
    block: int,
    f32_acc: bool = False,
) -> torch.Tensor:
    """Blocked Multi-TTM with the Algorithm-2 loop order, as an einsum.

    The tensor modes are cut into uniform ``block``-sized blocks whose
    coordinates become explicit contraction indices (the schedule of
    ``core.bounds.multi_ttm_blocked_cost``). ``matrices[k]`` is
    ``(I_k, R_k)``; mode ``keep`` (if not None) stays uncontracted and its
    matrix is ignored. Output modes keep their tensor positions:
    ``(R_1, ..., I_keep, ..., R_N)``. ``f32_acc=True`` widens the operands
    to float32 (exact) under a narrow ``compute_dtype`` policy.
    """
    n = x.ndim
    dims = x.shape
    if f32_acc:
        x = x.float()
    xp = _pad_rows(x, block)
    newshape: list[int] = []
    for d in xp.shape:
        newshape += [d // block, block]
    xb = xp.reshape(newshape)
    t_sub = "".join(_L[2 * k] + _L[2 * k + 1] for k in range(n))
    rank_l = "ABCDEFGH"
    f_subs, f_ops, out_sub = [], [], ""
    for k in range(n):
        if k == keep:
            out_sub += _L[2 * k] + _L[2 * k + 1]
            continue
        mk = matrices[k]
        if mk is None:
            raise ValueError(f"matrix {k} is None but mode {k} is contracted (keep={keep})")
        if f32_acc:
            mk = mk.float()
        mp = F.pad(mk, (0, 0, 0, (-mk.shape[0]) % block))
        f_ops.append(mp.reshape(mp.shape[0] // block, block, mk.shape[1]))
        f_subs.append(_L[2 * k] + _L[2 * k + 1] + rank_l[k])
        out_sub += rank_l[k]
    spec = ",".join([t_sub] + f_subs) + "->" + out_sub
    out = torch.einsum(spec, xb, *f_ops)
    if keep is not None:
        # the kept mode's (blk, in) axis pair sits at position `keep` (every
        # earlier mode contributes one rank axis): merge it and cut the padding
        shape = out.shape
        out = out.reshape(shape[:keep] + (shape[keep] * shape[keep + 1],) + shape[keep + 2:])
        out = out.narrow(keep, 0, dims[keep])
    return out


def mttkrp_blocked_reference_check(
    x: torch.Tensor, factors: Sequence[torch.Tensor], mode: int, block: int
) -> torch.Tensor:
    """abs-max discrepancy between blocked and direct MTTKRP (for tests)."""
    a = mttkrp_blocked(x, factors, mode, block)
    b = mttkrp(x, factors, mode)
    return torch.max(torch.abs(a - b))
