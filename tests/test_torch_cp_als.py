"""The port's CP-ALS (``device="cpu"``) against ``repro.cp_als``.

Both packages start from the same explicit initial factors (made with
numpy: JAX's PRNG cannot be reproduced). The reference runs its Pallas
kernels in interpret mode (``backend="pallas"``) and its einsum backend;
the port runs ``backend="cuda"`` (the kernels' plain versions on CPU
tensors), ``einsum`` and ``blocked_host``. Tolerances: per-iteration fits
within 1e-5; factors and weights within 1e-4 of their largest magnitude
(float32 ALS from the same start drifts by a few ulps per iteration).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro_torch.convert import factors_from_numpy

from _torch_parity import assert_same_cp as _assert_same
from _torch_parity import problem as _problem


def _ref(x, init, rank, iters, backend):
    kw = {"interpret": True} if backend == "pallas" else {}
    ctx = repro.ExecutionContext.create(backend=backend, **kw)
    return repro.cp_als(jnp.asarray(x), rank, iters,
                        init_factors=[jnp.asarray(f) for f in init], ctx=ctx)


def _port(x, init, rank, iters, backend):
    ctx = repro_torch.ExecutionContext.create(backend, device="cpu")
    return repro_torch.cp_als(torch.from_numpy(x), rank, iters,
                              init_factors=factors_from_numpy(init, "cpu"), ctx=ctx)


@pytest.mark.parametrize("dims,rank,iters,seed", [
    ((9, 7, 8), 3, 3, 0),
    ((5, 6, 4, 7), 2, 3, 1),
])
def test_cp_als_matches_pallas_interpret(dims, rank, iters, seed):
    x, init = _problem(dims, rank, seed)
    ref = _ref(x, init, rank, iters, "pallas")
    _assert_same(_port(x, init, rank, iters, "cuda"), ref)


@pytest.mark.parametrize("port_backend", ["einsum", "blocked_host", "cuda"])
def test_cp_als_matches_einsum_reference(port_backend):
    x, init = _problem((10, 9, 8), 4, 2)
    ref = _ref(x, init, 4, 6, "einsum")
    _assert_same(_port(x, init, 4, 6, port_backend), ref)


def test_cp_als_result_is_in_kruskal_form():
    x, init = _problem((8, 7, 6), 3, 3)
    res = _port(x, init, 3, 8, "einsum")
    for f in res.factors:  # columns normalized; lambda only in weights
        np.testing.assert_allclose(torch.linalg.vector_norm(f, dim=0).numpy(), 1.0, atol=1e-5)
    fit = 1 - float(torch.linalg.vector_norm(torch.from_numpy(x) - res.reconstruct())
                    / torch.linalg.vector_norm(torch.from_numpy(x)))
    assert abs(fit - res.final_fit) < 1e-4
    assert all(b >= a - 1e-6 for a, b in zip(res.fits, res.fits[1:]))  # ALS is monotone


def test_cp_als_tol_stops_early_and_random_init_runs():
    x, init = _problem((8, 7, 6), 2, 4)
    ctx = repro_torch.ExecutionContext.create("einsum", device="cpu")
    res = repro_torch.cp_als(torch.from_numpy(x), 2, 50, init_factors=factors_from_numpy(
        init, "cpu"), tol=1e-3, ctx=ctx)
    assert len(res.fits) < 50
    g = torch.Generator().manual_seed(3)
    a = repro_torch.cp_als(torch.from_numpy(x), 2, 3, generator=g, ctx=ctx)
    b = repro_torch.cp_als(torch.from_numpy(x), 2, 3,
                           generator=torch.Generator().manual_seed(3), ctx=ctx)
    assert a.fits == b.fits


@pytest.mark.parametrize("sweep", ["auto", "nope"])
def test_later_sweeps_are_rejected_by_name(sweep, tmp_path, monkeypatch):
    """An unknown sweep is rejected by name; ``"auto"``, which the tuning
    slice brought, resolves (a miss on a 3-way tensor: ``"fused"``)."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "plans.json"))
    x, init = _problem((4, 4, 4), 2, 5)
    ctx = repro_torch.ExecutionContext.create("einsum", device="cpu")
    if sweep == "auto":
        kw = dict(init_factors=factors_from_numpy(init, "cpu"), ctx=ctx)
        auto = repro_torch.cp_als(torch.from_numpy(x), 2, 1, sweep=sweep, **kw)
        assert auto.fits == repro_torch.cp_als(torch.from_numpy(x), 2, 1, sweep="fused",
                                               **kw).fits
        return
    with pytest.raises(ValueError, match="unknown"):
        repro_torch.cp_als(torch.from_numpy(x), 2, 1, sweep=sweep, ctx=ctx)
