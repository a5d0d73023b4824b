"""Two repairs of the port against the reference, on the CPU.

* float64: ``cp_als`` and ``tucker_hooi`` run on a float64 tensor, as the
  reference does under x64. ``frob_norm`` casts to float32 and then takes
  the norm for every input dtype, as ``repro.core.tensor.frob_norm`` does.
  The reference runs inside ``jax.enable_x64`` scoped to each call, so the
  other tests on the same worker keep float32. Tolerances: fits within 1e-5
  a step and factors within 1e-4 of their largest magnitude (the reported
  fit is taken from float32 norms in both packages, so it carries their
  rounding: about 1e-7 / (2 (1 - fit))); the results stay float64.
* a 2-way MTTKRP on ``backend="cuda"`` runs ``mttkrpn`` with one contraction
  axis (here, on CPU tensors, its plain version) instead of ``torch.einsum``;
  a 1-way tensor raises, naming einsum. Outputs within 1e-5 of the
  reference's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro_torch.convert import factors_from_numpy
from repro_torch.core.tensor import frob_norm
from repro_torch.kernels import ops
from repro_torch.kernels.mttkrp3 import mttkrp3
from repro_torch.kernels.mttkrpn import mttkrpn

from _torch_parity import FIT_TOL, PARAM_TOL, close, data, problem

BACKENDS = ["einsum", "blocked_host", "cuda"]


def _f64_problem():
    x, init = problem((9, 8, 7), 2, 0)
    return x.astype(np.float64), [f.astype(np.float64) for f in init]


def _ctx(backend):
    return repro_torch.ExecutionContext.create(backend, device="cpu")


def _assert_close64(got, want, tol):
    want = np.asarray(want)
    assert got.dtype == torch.float64 and want.dtype == np.float64
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= tol * max(float(np.abs(want).max()), 1.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_frob_norm_casts_to_float32_first(dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((5, 6, 7))).to(dtype)
    got = frob_norm(x)
    assert got.dtype == torch.float32
    want = np.asarray(repro.core.tensor.frob_norm(jnp.asarray(x.float().numpy())))
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_cp_als_float64_matches_reference_under_x64(backend):
    x, init = _f64_problem()
    with jax.enable_x64(True):
        ref = repro.cp_als(jnp.asarray(x), 2, 3, init_factors=[jnp.asarray(f) for f in init],
                           ctx=repro.ExecutionContext.create(backend="einsum"))
        ref_fits = list(ref.fits)
        ref_factors = [np.asarray(f) for f in ref.factors]
        ref_weights = np.asarray(ref.weights)
    got = repro_torch.cp_als(torch.from_numpy(x), 2, 3,
                             init_factors=factors_from_numpy(init, "cpu"), ctx=_ctx(backend))
    np.testing.assert_allclose(got.fits, ref_fits, rtol=0, atol=FIT_TOL)
    for a, b in zip(got.factors + [got.weights], ref_factors + [ref_weights]):
        _assert_close64(a, b, PARAM_TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_tucker_hooi_float64_matches_reference_under_x64(backend):
    x, _ = _f64_problem()
    with jax.enable_x64(True):
        ref = repro.tucker_hooi(jnp.asarray(x), (3, 2, 2), 3,
                                ctx=repro.ExecutionContext.create(backend="einsum"))
        ref_fits = list(ref.fits)
        ref_core = np.asarray(ref.core)
    got = repro_torch.tucker_hooi(torch.from_numpy(x), (3, 2, 2), 3, ctx=_ctx(backend))
    np.testing.assert_allclose(got.fits, ref_fits, rtol=0, atol=FIT_TOL)
    _assert_close64(got.core.abs(), np.abs(ref_core), PARAM_TOL)  # up to the sign convention


def test_x64_stays_scoped():
    with jax.enable_x64(True):
        assert jnp.asarray(np.zeros(2)).dtype == jnp.float64
    assert jnp.asarray(np.zeros(2)).dtype == jnp.float32


@pytest.mark.parametrize("mode", [0, 1])
def test_two_way_mttkrp_on_cuda_runs_the_kernel(mode):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((9, 7), dtype=np.float32)
    fs = [rng.standard_normal((d, 3), dtype=np.float32) for d in (9, 7)]
    want = repro.mttkrp(jnp.asarray(x), [jnp.asarray(f) for f in fs], mode,
                        ctx=repro.ExecutionContext.create(backend="einsum"))
    seen = []
    real = ops.mttkrp_canonical
    try:
        ops.mttkrp_canonical = lambda xp, f, **kw: seen.append(tuple(xp.shape)) or real(xp, f, **kw)
        got = repro_torch.mttkrp(torch.from_numpy(x), [torch.from_numpy(f) for f in fs], mode,
                                 ctx=_ctx("cuda"))
    finally:
        ops.mttkrp_canonical = real
    assert seen == [(x.shape[mode], x.shape[1 - mode])]  # canonical, one contraction axis
    close(got, want)


def test_two_way_cp_als_on_cuda_matches_reference():
    x, init = data((12, 10), 3, seed=5)  # no low-rank structure: the fit stays far from 1
    ref = repro.cp_als(jnp.asarray(x), 3, 4, init_factors=[jnp.asarray(f) for f in init],
                       ctx=repro.ExecutionContext.create(backend="einsum"))
    before = (mttkrpn.launches, mttkrp3.launches)  # CPU tensors launch nothing
    got = repro_torch.cp_als(torch.from_numpy(x), 3, 4,
                             init_factors=factors_from_numpy(init, "cpu"), ctx=_ctx("cuda"))
    assert (mttkrpn.launches, mttkrp3.launches) == before
    np.testing.assert_allclose(got.fits, ref.fits, rtol=0, atol=FIT_TOL)


def test_one_way_mttkrp_on_cuda_raises_naming_einsum():
    with pytest.raises(ValueError, match="einsum"):
        repro_torch.mttkrp(torch.zeros(5), [torch.zeros((5, 2))], 0, ctx=_ctx("cuda"))
