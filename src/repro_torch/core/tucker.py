"""Tucker decomposition (PyTorch): HOSVD initialization and HOOI sweeps.
Counterpart of ``repro.core.tucker`` (``TuckerResult``, ``ttm``,
``hosvd_init``, ``tucker_hooi``).

Every HOOI mode update is a Multi-TTM

    Y^(k) = X x_{j != k} A_j^T        (the kept-mode partial contraction)

through :func:`repro_torch.engine.execute.multi_ttm` under one
:class:`~repro_torch.engine.context.ExecutionContext` (on ``cuda``, one
launch of the Hopper Multi-TTM kernel), followed by the eigendecomposition
of the small unfolding Gram ``Y_(k) Y_(k)^T``. The fit uses the
orthonormal-factor identity ``||X - [[G; A_1..A_N]]||^2 = ||X||^2 -
||G||^2``, so the full tensor is never rebuilt.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import torch

from ..engine import execute as engine_execute
from ..engine.context import ExecutionContext
from ..observe import trace as _otrace
from .tensor import frob_norm


@dataclass
class TuckerResult:
    """A Tucker decomposition: ``core`` of shape ``(R_1, ..., R_N)`` and
    orthonormal ``factors`` (``A_k`` of shape ``(I_k, R_k)``), plus the
    per-sweep ``fits``."""

    core: torch.Tensor
    factors: list[torch.Tensor]
    fits: list[float] = field(default_factory=list)

    @property
    def final_fit(self) -> float:
        return self.fits[-1] if self.fits else float("nan")

    @property
    def ranks(self) -> tuple[int, ...]:
        return tuple(self.core.shape)

    def reconstruct(self) -> torch.Tensor:
        """Full tensor ``G x_1 A_1 ... x_N A_N``."""
        out = self.core
        for k, a in enumerate(self.factors):
            out = ttm(out, a, k, transpose=False)
        return out


def ttm(x: torch.Tensor, a: torch.Tensor, mode: int, transpose: bool = True) -> torch.Tensor:
    """Single tensor-times-matrix: contract tensor mode ``mode`` with ``a``,
    ``A^T`` applied (``transpose=True``, extent ``I_k -> R_k``) or ``A``
    applied (``transpose=False``, ``R_k -> I_k``, reconstruction)."""
    out = torch.tensordot(x, a, dims=([mode], [0 if transpose else 1]))
    # tensordot appends the matrix's free axis; rotate it back into place
    return out.movedim(-1, mode)


def _fix_signs(v: torch.Tensor) -> torch.Tensor:
    """Deterministic eigenvector sign convention: the largest-magnitude
    entry of every column is made positive (a zero sign counts as +1)."""
    idx = torch.argmax(v.abs(), dim=0)
    signs = torch.sign(v[idx, torch.arange(v.shape[1], device=v.device)])
    return v * torch.where(signs == 0, torch.ones_like(signs), signs)


def _leading_eigvecs(gram: torch.Tensor, r: int) -> torch.Tensor:
    """Top-``r`` eigenvectors of a PSD Gram (ascending ``eigh`` on the
    float32 Gram, reversed), with the sign convention."""
    _, v = torch.linalg.eigh(gram.float())
    return _fix_signs(v.flip(-1)[:, :r])


def _gram_eigvecs(m: torch.Tensor, r: int) -> torch.Tensor:
    """The top-``r`` left singular vectors of ``m``: the leading
    eigenvectors of its row Gram ``m m^T``."""
    return _leading_eigvecs(m @ m.T, r)


def _unfold_rows(z: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode-``mode``-rows unfolding ``(I_mode, prod rest)`` (the column
    order only has to be consistent)."""
    return z.movedim(mode, 0).reshape(z.shape[mode], -1)


def hosvd_init(x: torch.Tensor, ranks: Sequence[int], dtype=torch.float32
               ) -> list[torch.Tensor]:
    """HOSVD factors: the top-``R_k`` left singular vectors of every
    unfolding ``X_(k)``, from the ``I_k x I_k`` Gram's eigendecomposition,
    in ``x``'s dtype. ``dtype`` is taken and not read, as in the reference."""
    return [_gram_eigvecs(_unfold_rows(x, k), int(r)).to(x.dtype) for k, r in enumerate(ranks)]


def _check_ranks(shape: Sequence[int], ranks: Sequence[int]) -> tuple[int, ...]:
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) != len(shape):
        raise ValueError(
            f"Tucker ranks {ranks} must give one rank per tensor mode "
            f"({len(shape)} for shape {tuple(shape)})"
        )
    for k, (r, d) in enumerate(zip(ranks, shape)):
        if not 1 <= r <= d:
            raise ValueError(f"Tucker rank R_{k}={r} out of range [1, I_{k}={d}]")
    return ranks


def _fit(normx: torch.Tensor, core: torch.Tensor) -> float:
    err_sq = torch.clamp(normx ** 2 - frob_norm(core) ** 2, min=0.0)
    return float(1.0 - torch.sqrt(err_sq) / torch.clamp(normx, min=1e-30))


def tucker_hooi(
    x: torch.Tensor,
    ranks: Sequence[int],
    n_iters: int = 10,
    *,
    ctx: ExecutionContext | None = None,
    init_factors: Sequence[torch.Tensor] | None = None,
    tol: float = 0.0,
) -> TuckerResult:
    """Tucker decomposition by HOOI (higher-order orthogonal iteration).

    One sweep = for each mode k: ``Y = multi_ttm(x, factors, keep=k)``,
    then ``A_k`` = the top-``R_k`` eigenvectors of ``Y_(k) Y_(k)^T``. Every
    Multi-TTM goes through the engine under ``ctx`` (default
    ``ExecutionContext.default()``: the Hopper kernel on the card, one launch per
    mode); on ``backend="auto"`` each resolves through the tune cache
    (``resolve_multi_ttm``; a context from ``ExecutionContext.for_problem``
    with the Tucker ranks replays its pinned decisions). A distributed
    context routes to the stationary-tensor sweep driver
    (:func:`repro_torch.distributed.tucker_parallel.tucker_hooi_parallel`):
    X is block-distributed over a Multi-TTM-sweep-optimal grid of the
    initialized default group, every rank calling with the whole tensor.

    Initialization is HOSVD (``init_factors`` overrides). ``n_iters < 1``
    projects onto the initial factors only (one full-core Multi-TTM).
    ``tol`` stops early when the fit changes by less between sweeps. The
    core comes out of the last mode update, with no extra pass over X.
    Returns a :class:`TuckerResult`."""
    ctx = ctx if ctx is not None else ExecutionContext.default()
    ranks = _check_ranks(x.shape, ranks)
    if ctx.is_distributed:
        from ..distributed.tucker_parallel import tucker_hooi_parallel  # call-time: layer cycle

        return tucker_hooi_parallel(x, ranks, n_iters, ctx=ctx, init_factors=init_factors,
                                    tol=tol)
    ctx.check_tensor("repro_torch.tucker_hooi", x, *(init_factors or ()))
    n = x.ndim
    if init_factors is not None:
        factors = [f.to(x.dtype) for f in init_factors]
    else:
        factors = hosvd_init(x, ranks)
    normx = frob_norm(x)
    fits: list[float] = []
    if n_iters < 1:  # HOSVD only: project onto the initial factors
        core = engine_execute.multi_ttm(x, factors, keep=None, ctx=ctx)
        fits.append(_fit(normx, core))
        return TuckerResult(core, factors, fits)
    for it in range(n_iters):
        for k in range(n):
            y = engine_execute.multi_ttm(x, factors, keep=k, ctx=ctx)
            factors[k] = _gram_eigvecs(_unfold_rows(y, k), ranks[k]).to(x.dtype)
        # the core falls out of the last mode update: contract mode N-1 of
        # its Y with the fresh A_{N-1} (no extra pass over X)
        core = ttm(y, factors[n - 1], n - 1)
        fit = _fit(normx, core)
        fits.append(fit)
        delta = abs(fits[-1] - fits[-2]) if it > 0 else None
        converged = bool(tol and it > 0 and delta < tol)
        if _otrace.should_record(ctx.observe):
            _otrace.record_event("tucker_iter", shape=list(x.shape), ranks=list(ranks), it=it,
                                 fit=fit, fit_delta=delta, converged=converged)
        if converged:
            break
    return TuckerResult(core, factors, fits)
