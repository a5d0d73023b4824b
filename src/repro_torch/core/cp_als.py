"""CP-ALS and gradient-based CP (PyTorch). Counterpart of
``repro.core.cp_als`` (``CPResult``, ``cp_als``, ``cp_gradient``).

One sweep = for each mode n: B = MTTKRP(X, A, n) through the engine; solve
the normal equations A_n Γ_n = B in float32 with a small ridge;
column-normalize, keeping the scales λ only in ``weights``. Three sweep
schedules deliver the B's, all Gauss-Seidel exact: ``per_mode`` (N
MTTKRPs), ``fused`` (the mode-reuse schedule, :mod:`..engine.sweep`) and
``dimtree`` (the binary dimension tree, :mod:`..engine.tree`). The fit
uses the inner-product identity

    ||X - recon||^2 = ||X||^2 - 2<B^(N-1), A^(N-1)> + 1^T (Γ ∘ A_N^T A_N) 1

so the full tensor is never rebuilt.

``cp_gradient`` is Adam on 0.5 ||X - [[A]]||_F^2 with the analytic gradient
dL/dA_n = A_n Γ_n - MTTKRP(X, A, n), every MTTKRP through the engine too.
Both drivers take a ``mttkrp_fn(x, factors, mode)`` that replaces the
engine's MTTKRP on their per-mode path (the hook the distributed drivers
plug into).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch

from ..engine import execute as engine_execute
from ..engine.context import ExecutionContext, check_driver_options
from ..engine.sweep import fused_als_sweep
from ..engine.tree import dimtree_als_sweep
from ..observe import trace as _otrace
from .tensor import frob_norm, random_factors, tensor_from_factors

MttkrpFn = Callable[[torch.Tensor, Sequence[torch.Tensor], int], torch.Tensor]


@dataclass
class CPResult:
    """A Kruskal-form decomposition: column-normalized ``factors`` plus the
    column scales ``weights`` (λ), which live only here."""

    factors: list[torch.Tensor]
    weights: torch.Tensor
    fits: list[float] = field(default_factory=list)

    @property
    def final_fit(self) -> float:
        return self.fits[-1] if self.fits else float("nan")

    def reconstruct(self) -> torch.Tensor:
        return tensor_from_factors(self.factors, self.weights)


def _grams(factors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    return [f.T @ f for f in factors]


def _hadamard_except(grams: Sequence[torch.Tensor], skip: int) -> torch.Tensor:
    rank = grams[0].shape[0]
    out = torch.ones((rank, rank), dtype=grams[0].dtype, device=grams[0].device)
    for k, g in enumerate(grams):
        if k != skip:
            out = out * g
    return out


def _fit(normx: torch.Tensor, b_last: torch.Tensor, a_last: torch.Tensor,
         gram_had_all: torch.Tensor) -> torch.Tensor:
    """1 - ||X - recon|| / ||X|| via the inner-product identity."""
    inner = torch.sum(b_last * a_last)
    norm_recon_sq = torch.sum(gram_had_all)
    err_sq = torch.clamp(normx ** 2 - 2 * inner + norm_recon_sq, min=0.0)
    return 1.0 - torch.sqrt(err_sq) / torch.clamp(normx, min=1e-30)


_SWEEPS = ("per_mode", "fused", "dimtree")


def cp_als(
    x: torch.Tensor,
    rank: int,
    n_iters: int = 20,
    *,
    init_factors: Sequence[torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
    mttkrp_fn: MttkrpFn | None = None,
    use_dimension_tree: bool = False,
    tol: float = 0.0,
    sweep: str | None = None,
    ctx: ExecutionContext | None = None,
) -> CPResult:
    """CP-ALS with every MTTKRP through the engine under ``ctx`` (default
    ``ExecutionContext.default()``: the Hopper kernels on the card).

    ``init_factors`` start the iteration (tests pass the reference's); else
    the factors are drawn from ``generator`` (default: seed 0 on the
    context's device). ``tol > 0`` stops once the fit changes by less.
    ``sweep`` picks the schedule: ``"per_mode"`` (the default),
    ``"fused"`` (two tensor passes a sweep; one fused pair kernel launch on
    ``cuda``) or ``"dimtree"``; ``use_dimension_tree=True`` is the
    reference's alias of ``sweep="dimtree"`` (passing another ``sweep``
    beside it raises), or ``"auto"``: the schedule (and the fused pair
    kernel's plan) resolved through the tune cache under ``kind="sweep"``,
    searched first when ``ctx.tune`` (a miss: ``"fused"`` for 3-way tensors
    and up). ``mttkrp_fn(x, factors, mode)`` replaces the engine's MTTKRP on
    the ``per_mode`` schedule, as in the reference. ``ctx.backend="auto"``
    resolves every contraction through the tune cache. A distributed
    context (``ctx.distribution``) runs the stationary-tensor sweep of
    :func:`repro_torch.distributed.cp_als_parallel.cp_als_parallel` on the
    initialized ``torch.distributed`` group instead (``sweep`` may only be
    ``"per_mode"`` there, and ``mttkrp_fn`` is refused)."""
    ctx = ctx if ctx is not None else ExecutionContext.default()
    check_driver_options(ctx, mttkrp_fn=mttkrp_fn, use_dimension_tree=use_dimension_tree)
    if sweep is not None:
        if sweep not in _SWEEPS + ("auto",):
            raise ValueError(f"unknown sweep {sweep!r}; expected one of {_SWEEPS + ('auto',)}")
        if use_dimension_tree and sweep != "dimtree":
            raise ValueError(
                f"sweep={sweep!r} conflicts with use_dimension_tree=True (pass only one of "
                f"the two)"
            )
        if ctx.is_distributed and sweep != "per_mode":
            raise ValueError(
                f"sweep={sweep!r} is not supported on the distributed path "
                f"(the stationary sweep already amortizes factor gathers; "
                f"overlap='ring' is its comm/compute-overlap knob)"
            )
    if ctx.is_distributed:
        from ..distributed.cp_als_parallel import cp_als_parallel  # call-time: layer cycle

        return cp_als_parallel(x, rank, n_iters, generator=generator,
                               init_factors=init_factors, ctx=ctx, tol=tol)
    ctx.check_tensor("repro_torch.cp_als", x, *(init_factors or ()))
    schedule = sweep if sweep is not None else ("dimtree" if use_dimension_tree else "per_mode")
    pair_plan = None
    if schedule == "auto":
        from ..tune.search import resolve_sweep, tune_sweep  # call-time: tune imports us

        if ctx.tune:
            tune_sweep(x, rank, ctx=ctx)
        resolved = resolve_sweep(x.shape, rank, x.dtype, ctx.memory, cache=ctx.plan_cache(),
                                 device=ctx.device)
        schedule, pair_plan = resolved.variant, resolved.plan
    if mttkrp_fn is None:
        def mttkrp_fn(t, fs, mode):
            return engine_execute.mttkrp(t, fs, mode, ctx=ctx)
    n = x.ndim
    if init_factors is not None:
        factors = [f.to(x.dtype) for f in init_factors]
    else:
        if generator is None:
            generator = torch.Generator(device=ctx.torch_device).manual_seed(0)
        factors = random_factors(generator, x.shape, rank, x.dtype)
    normx = frob_norm(x)
    grams = _grams(factors)
    fits: list[float] = []
    weights = torch.ones((rank,), dtype=x.dtype, device=x.device)
    solve_dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    eye = torch.eye(rank, dtype=solve_dtype, device=x.device)
    last: dict[str, torch.Tensor] = {}

    def update(mode: int, b: torch.Tensor) -> torch.Tensor:
        nonlocal weights
        gamma = _hadamard_except(grams, mode).to(solve_dtype)
        # solve A_n Γ = B (Γ is PSD; the ridge guards rank deficiency)
        ridge = 1e-5 * torch.trace(gamma) / rank + 1e-12
        a_new = torch.linalg.solve(gamma + ridge * eye, b.to(solve_dtype).T).T.to(x.dtype)
        lam = torch.clamp(torch.linalg.vector_norm(a_new, dim=0), min=1e-30)
        a_new = a_new / lam
        weights = lam.to(x.dtype)
        grams[mode] = a_new.T @ a_new
        last["b"], last["a"] = b, a_new * weights
        return a_new

    for it in range(n_iters):
        if schedule == "fused":
            fused_als_sweep(x, factors, update, ctx=ctx, pair_plan=pair_plan)
        elif schedule == "dimtree":
            dimtree_als_sweep(x, factors, update, ctx=ctx)
        else:
            for mode in range(n):
                factors[mode] = update(mode, mttkrp_fn(x, factors, mode))
        gram_full = _hadamard_except(grams, -1) * torch.outer(weights, weights)
        fit = float(_fit(normx, last["b"], last["a"], gram_full))
        fits.append(fit)
        delta = abs(fits[-1] - fits[-2]) if it > 0 else None
        converged = bool(tol and it > 0 and delta < tol)
        # float(_fit) above waits for the device: never under graph capture
        if _otrace.should_record(ctx.observe):
            _otrace.record_event("cp_als_iter", shape=list(x.shape), rank=int(rank),
                                 schedule=schedule, it=it, fit=fit, fit_delta=delta,
                                 weights=[float(w) for w in weights.tolist()],
                                 converged=converged)
        if converged:
            break
    return CPResult(factors, weights, fits)


def cp_gradient(
    x: torch.Tensor,
    rank: int,
    n_iters: int = 200,
    lr: float = 0.05,
    *,
    init_factors: Sequence[torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
    mttkrp_fn: MttkrpFn | None = None,
    ctx: ExecutionContext | None = None,
) -> CPResult:
    """Gradient-based CP: Adam on the analytic MTTKRP gradient, every MTTKRP
    through ``engine.execute.mttkrp`` under ``ctx`` (as :func:`cp_als`) or
    through ``mttkrp_fn``. ``init_factors`` start it (the parity tests pass
    the reference's ``random_factors(key, ...)`` start); else the factors are
    drawn from ``generator`` (default: seed 0 on the context's device). A fit
    is recorded every 10 steps and at the last. The result's ``weights`` are
    ones (the factors carry the scale)."""
    ctx = ctx if ctx is not None else ExecutionContext.default()
    ctx.check_tensor("repro_torch.cp_gradient", x, *(init_factors or ()))
    n = x.ndim
    if mttkrp_fn is None:
        def mttkrp_fn(t, fs, mode):
            return engine_execute.mttkrp(t, fs, mode, ctx=ctx)
    if init_factors is not None:
        factors = [f.to(x.dtype) for f in init_factors]
    else:
        if generator is None:
            generator = torch.Generator(device=ctx.torch_device).manual_seed(0)
        factors = random_factors(generator, x.shape, rank, x.dtype)
    normx = frob_norm(x)
    m = [torch.zeros_like(f) for f in factors]
    v = [torch.zeros_like(f) for f in factors]
    b1, b2, eps = 0.9, 0.999, 1e-8
    fits: list[float] = []
    for it in range(1, n_iters + 1):
        grams = _grams(factors)
        grads = []
        for mode in range(n):
            b = mttkrp_fn(x, factors, mode)
            grads.append(factors[mode] @ _hadamard_except(grams, mode) - b)
        for k in range(n):
            m[k] = b1 * m[k] + (1 - b1) * grads[k]
            v[k] = b2 * v[k] + (1 - b2) * torch.square(grads[k])
            mhat = m[k] / (1 - b1 ** it)
            vhat = v[k] / (1 - b2 ** it)
            factors[k] = factors[k] - lr * mhat / (torch.sqrt(vhat) + eps)
        if it % 10 == 0 or it == n_iters:
            b = mttkrp_fn(x, factors, n - 1)
            gram_full = _hadamard_except(_grams(factors), -1)
            fits.append(float(_fit(normx, b, factors[n - 1], gram_full)))
    return CPResult(factors, torch.ones((rank,), dtype=x.dtype, device=x.device), fits)
