"""Batched execution: decompose B tensors of one shape in one run.
Counterpart of ``repro.engine.batch`` (``batched_choose_blocks``,
``BatchedCPResult``, ``cp_als_batched``, ``BatchedTuckerResult``,
``tucker_hooi_batched``).

Every per-mode MTTKRP of a CP-ALS sweep and every Multi-TTM of a HOOI sweep
is ONE batched engine call (a leading batch axis on
:func:`repro_torch.engine.execute.mttkrp` / ``multi_ttm``): on ``cuda`` one
kernel launch for all B tensors, the batch the kernels' grid z dimension,
so the host pays for a call once, not B times. The Gram, solve,
normalization and ``eigh`` tails run batched through ``torch.linalg``. A
per-element convergence mask freezes an element once it has converged: its
factors, weights, Grams, fit and iteration counter stop changing, bit for
bit, and the loop ends when every element has converged.

JAX's PRNG cannot be reproduced in torch, so ``cp_als_batched`` takes
``init_factors`` or a ``torch.Generator`` in place of the reference's key.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import torch

from ..core.cp_als import CPResult
from ..core.tensor import random_factors
from ..core.tucker import TuckerResult, _check_ranks
from ..observe import trace as _otrace
from . import execute as engine_execute
from .context import ExecutionContext
from .plan import batched_choose_blocks

__all__ = [
    "BatchedCPResult",
    "BatchedTuckerResult",
    "batched_choose_blocks",
    "cp_als_batched",
    "tucker_hooi_batched",
]


def _batched_norms(x: torch.Tensor) -> torch.Tensor:
    """The Frobenius norm of every element, in float32, as ``frob_norm``
    takes one (a float64 tensor rounded to float32 first)."""
    if x.dtype == torch.float64:
        x = x.float()
    return torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=1, dtype=torch.float32)


def _mask(active: torch.Tensor, ndim: int) -> torch.Tensor:
    """``active`` shaped to broadcast over a ``(B, ...)`` tensor of ``ndim``
    axes."""
    return active.reshape((-1,) + (1,) * (ndim - 1))


def _check_init(init_factors, batch: int, dims, ranks, dtype) -> list[torch.Tensor]:
    factors = [f.to(dtype) for f in init_factors]
    for k, f in enumerate(factors):
        if tuple(f.shape) != (batch, dims[k], ranks[k]):
            raise ValueError(
                f"init_factors[{k}] must be (B, I_k, R) = ({batch}, {dims[k]}, {ranks[k]}), "
                f"got {tuple(f.shape)}"
            )
    return factors


# ---------------------------------------------------------------------------
# Batched CP-ALS
# ---------------------------------------------------------------------------

@dataclass
class BatchedCPResult:
    """B Kruskal-form decompositions from one batched run: ``factors[k]`` is
    ``(B, I_k, R)`` (column-normalized per element), ``weights`` ``(B, R)``,
    ``fits`` ``(B,)`` (the final fit of each element), ``n_iters`` ``(B,)``
    (the sweeps that updated each element: a converged element's counter
    stops), ``converged`` ``(B,)``, ``fit_history`` one ``(B,)`` tensor a
    sweep. ``result(b)`` is element b as a :class:`CPResult`."""

    factors: list[torch.Tensor]
    weights: torch.Tensor
    fits: torch.Tensor
    n_iters: torch.Tensor
    converged: torch.Tensor
    fit_history: list[torch.Tensor] = field(default_factory=list)

    @property
    def batch(self) -> int:
        return int(self.weights.shape[0])

    @property
    def ranks(self) -> tuple[int, ...]:
        """The CP rank of every mode's factor (one R throughout)."""
        return tuple(int(f.shape[-1]) for f in self.factors)

    def result(self, b: int) -> CPResult:
        """Element ``b`` as a plain :class:`CPResult` (the fit history of the
        sweeps that ran before the whole batch stopped)."""
        return CPResult([f[b] for f in self.factors], self.weights[b],
                        [float(h[b]) for h in self.fit_history])


def _batched_hadamard_except(grams: Sequence[torch.Tensor], skip: int) -> torch.Tensor:
    out = torch.ones_like(grams[0])
    for k, g in enumerate(grams):
        if k != skip:
            out = out * g
    return out


def _batched_fit(normx, b_last, a_last, gram_had_all) -> torch.Tensor:
    """Every element's fit by the inner-product identity (no
    reconstruction): ``1 - ||X_b - recon_b|| / ||X_b||``."""
    inner = torch.sum(b_last * a_last, dim=(1, 2))
    norm_recon_sq = torch.sum(gram_had_all, dim=(1, 2))
    err_sq = torch.clamp(normx ** 2 - 2 * inner + norm_recon_sq, min=0.0)
    return 1.0 - torch.sqrt(err_sq) / torch.clamp(normx, min=1e-30)


def cp_als_batched(
    x: torch.Tensor,
    rank: int,
    n_iters: int = 20,
    *,
    init_factors: Sequence[torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
    tol: float = 0.0,
    ctx: ExecutionContext | None = None,
) -> BatchedCPResult:
    """CP-ALS over a stack of B same-shaped tensors ``x (B, I_0, ...,
    I_{N-1})``, per-mode schedule, with every MTTKRP one batched engine
    call under ``ctx`` (default ``ExecutionContext.default()``: on the card, one
    kernel launch a mode for the whole batch).

    ``init_factors[k]`` is ``(B, I_k, R)``; else element b's factors are
    drawn from ``generator`` (default: seed 0 on the context's device) as
    :func:`repro_torch.cp_als` draws them, the elements in order. ``tol > 0``
    freezes an element once its fit changes by less (after the first
    sweep); the loop ends when every element has. Each element follows the
    trajectory of :func:`repro_torch.cp_als` from its start, to fp32
    rounding."""
    ctx = ctx if ctx is not None else ExecutionContext.default()
    if x.ndim < 3:
        raise ValueError(
            f"cp_als_batched needs a batch of >=2-way tensors (B, I_0, ..., I_N-1); got "
            f"shape {tuple(x.shape)}"
        )
    ctx.check_tensor("repro_torch.cp_als_batched", x, *(init_factors or ()))
    batch, dims = int(x.shape[0]), tuple(x.shape[1:])
    n = len(dims)
    if init_factors is not None:
        factors = _check_init(init_factors, batch, dims, [rank] * n, x.dtype)
    else:
        if generator is None:
            generator = torch.Generator(device=ctx.torch_device).manual_seed(0)
        draws = [random_factors(generator, dims, rank, x.dtype) for _ in range(batch)]
        factors = [torch.stack(f) for f in zip(*draws)]
    normx = _batched_norms(x)
    grams = [f.transpose(1, 2) @ f for f in factors]
    weights = torch.ones((batch, rank), dtype=x.dtype, device=x.device)
    converged = torch.zeros(batch, dtype=torch.bool, device=x.device)
    iters_run = torch.zeros(batch, dtype=torch.int32, device=x.device)
    fits = torch.zeros(batch, dtype=torch.promote_types(torch.float32, x.dtype),
                       device=x.device)
    fit_history: list[torch.Tensor] = []
    solve_dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    eye = torch.eye(rank, dtype=solve_dtype, device=x.device)
    last: dict[str, torch.Tensor] = {}

    def update(mode: int, b: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """One batched mode update; elements where ``active`` is False keep
        their factor, weights and Gram bit for bit."""
        nonlocal weights
        gamma = _batched_hadamard_except(grams, mode).to(solve_dtype)
        ridge = (1e-5 * torch.diagonal(gamma, dim1=1, dim2=2).sum(-1) / rank + 1e-12)
        a_new = torch.linalg.solve(gamma + ridge[:, None, None] * eye,
                                   b.to(solve_dtype).transpose(1, 2))
        a_new = a_new.transpose(1, 2).to(x.dtype)
        lam = torch.clamp(torch.linalg.vector_norm(a_new, dim=1), min=1e-30)
        a_new = a_new / lam[:, None, :]
        a_new = torch.where(_mask(active, 3), a_new, factors[mode])
        weights = torch.where(_mask(active, 2), lam.to(x.dtype), weights)
        grams[mode] = torch.where(_mask(active, 3), a_new.transpose(1, 2) @ a_new, grams[mode])
        last["b"], last["a"] = b, a_new * weights[:, None, :]
        return a_new

    for it in range(n_iters):
        active = ~converged
        for mode in range(n):
            # ONE batched engine call for all B elements
            b = engine_execute.mttkrp(x, factors, mode, ctx=ctx)
            factors[mode] = update(mode, b, active)
        gram_full = _batched_hadamard_except(grams, -1) * (weights[:, :, None]
                                                           * weights[:, None, :])
        new_fits = _batched_fit(normx, last["b"], last["a"], gram_full).to(fits.dtype)
        new_fits = torch.where(active, new_fits, fits)
        delta = (new_fits - fits).abs()
        fits = new_fits
        fit_history.append(fits)
        iters_run = iters_run + active.to(torch.int32)
        if tol and it > 0:
            converged = converged | (active & (delta < tol))
        if _otrace.should_record(ctx.observe):
            _otrace.record_event("cp_als_batched_iter", batch=batch, shape=list(dims),
                                 rank=int(rank), it=it, fits=fits.tolist(),
                                 converged=converged.tolist())
        if tol and it > 0 and bool(converged.all()):
            break
    return BatchedCPResult(factors, weights, fits, iters_run, converged, fit_history)


# ---------------------------------------------------------------------------
# Batched Tucker/HOOI
# ---------------------------------------------------------------------------

@dataclass
class BatchedTuckerResult:
    """B Tucker decompositions from one batched HOOI run: ``core`` is
    ``(B, R_1, ..., R_N)``, ``factors[k]`` ``(B, I_k, R_k)`` (orthonormal
    columns per element), ``fits``, ``n_iters`` and ``converged`` per
    element as in :class:`BatchedCPResult`."""

    core: torch.Tensor
    factors: list[torch.Tensor]
    fits: torch.Tensor
    n_iters: torch.Tensor
    converged: torch.Tensor

    @property
    def batch(self) -> int:
        return int(self.core.shape[0])

    @property
    def ranks(self) -> tuple[int, ...]:
        return tuple(self.core.shape[1:])

    def result(self, b: int) -> TuckerResult:
        """Element ``b`` as a plain :class:`TuckerResult`."""
        return TuckerResult(self.core[b], [f[b] for f in self.factors], [float(self.fits[b])])


def _batched_leading_eigvecs(m: torch.Tensor, r: int) -> torch.Tensor:
    """For each element of ``m (B, I, J)``: the top-``r`` eigenvectors of its
    row Gram ``m m^T`` (ascending ``eigh`` on the float32 Grams, one batched
    call, reversed), with :func:`repro_torch.core.tucker._fix_signs`'s rule:
    each column's largest-magnitude entry made positive."""
    _, v = torch.linalg.eigh((m @ m.transpose(1, 2)).float())
    v = v.flip(-1)[:, :, :r]
    idx = torch.argmax(v.abs(), dim=1, keepdim=True)
    signs = torch.sign(torch.gather(v, 1, idx))
    return v * torch.where(signs == 0, torch.ones_like(signs), signs)


def _unfold_rows(z: torch.Tensor, mode: int) -> torch.Tensor:
    """Each element's mode-``mode``-rows unfolding: ``(B, I_mode, prod rest)``."""
    z = z.movedim(mode + 1, 1)
    return z.reshape(z.shape[0], z.shape[1], -1)


def tucker_hooi_batched(
    x: torch.Tensor,
    ranks: Sequence[int],
    n_iters: int = 10,
    *,
    ctx: ExecutionContext | None = None,
    init_factors: Sequence[torch.Tensor] | None = None,
    tol: float = 0.0,
) -> BatchedTuckerResult:
    """Tucker/HOOI over a stack of B same-shaped tensors ``x (B, I_1, ...,
    I_N)``. The start is a batched HOSVD (one batched ``eigh`` a mode;
    ``init_factors[k]`` of shape ``(B, I_k, R_k)`` overrides). Each mode
    update is ONE batched :func:`~repro_torch.engine.execute.multi_ttm` call
    (one kernel launch on ``cuda``) and one batched ``eigh``; the core falls
    out of the last mode's update. ``tol`` freezes converged elements as in
    :func:`cp_als_batched`; ``n_iters < 1`` projects onto the start (one
    batched full-core Multi-TTM), as :func:`repro_torch.tucker_hooi` does.
    Each element follows the trajectory of :func:`repro_torch.tucker_hooi`,
    to fp32 rounding."""
    ctx = ctx if ctx is not None else ExecutionContext.default()
    if x.ndim < 3:
        raise ValueError(
            f"tucker_hooi_batched needs a batch of >=2-way tensors (B, I_1, ..., I_N); got "
            f"shape {tuple(x.shape)}"
        )
    ctx.check_tensor("repro_torch.tucker_hooi_batched", x, *(init_factors or ()))
    batch, dims = int(x.shape[0]), tuple(x.shape[1:])
    n = len(dims)
    ranks = _check_ranks(dims, ranks)
    if init_factors is not None:
        factors = _check_init(init_factors, batch, dims, ranks, x.dtype)
    else:
        factors = [_batched_leading_eigvecs(_unfold_rows(x, k), ranks[k]).to(x.dtype)
                   for k in range(n)]
    normx = _batched_norms(x)
    converged = torch.zeros(batch, dtype=torch.bool, device=x.device)
    iters_run = torch.zeros(batch, dtype=torch.int32, device=x.device)
    fits = torch.zeros(batch, dtype=torch.float32, device=x.device)

    def fit_of(core: torch.Tensor) -> torch.Tensor:
        err_sq = torch.clamp(normx ** 2 - _batched_norms(core) ** 2, min=0.0)
        return 1.0 - torch.sqrt(err_sq) / torch.clamp(normx, min=1e-30)

    if n_iters < 1:  # the start only: project onto it
        core = engine_execute.multi_ttm(x, factors, keep=None, ctx=ctx)
        return BatchedTuckerResult(core, factors, fit_of(core), iters_run, converged)
    core = None
    for it in range(n_iters):
        active = ~converged
        for k in range(n):
            # ONE batched Multi-TTM call for all B elements
            y = engine_execute.multi_ttm(
                x, [None if j == k else factors[j] for j in range(n)], keep=k, ctx=ctx)
            a_new = _batched_leading_eigvecs(_unfold_rows(y, k), ranks[k]).to(x.dtype)
            factors[k] = torch.where(_mask(active, 3), a_new, factors[k])
        # the core falls out of the last mode update: contract mode N-1 of
        # each element's Y with its A_{N-1}
        new_core = torch.matmul(y, factors[n - 1][(slice(None),) + (None,) * (n - 2)])
        core = new_core if core is None else torch.where(_mask(active, n + 1), new_core, core)
        new_fits = torch.where(active, fit_of(core), fits)
        delta = (new_fits - fits).abs()
        fits = new_fits
        iters_run = iters_run + active.to(torch.int32)
        if tol and it > 0:
            converged = converged | (active & (delta < tol))
        if _otrace.should_record(ctx.observe):
            _otrace.record_event("tucker_batched_iter", batch=batch, shape=list(dims),
                                 ranks=list(ranks), it=it, fits=fits.tolist(),
                                 converged=converged.tolist())
        if tol and it > 0 and bool(converged.all()):
            break
    return BatchedTuckerResult(core, factors, fits, iters_run, converged)
