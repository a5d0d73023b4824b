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
* the keyword surface: ``hosvd_init`` takes the reference's ``dtype`` (and,
  as there, does not read it), and ``verify.comm.check_tucker_sweep`` names
  its second parameter ``ranks``. Parameter names equal the reference's;
  the HOSVD subspaces (``U Uᵀ``, free of the eigenvectors' signs) agree
  within 1e-4, and a sweep's bytes equal the reference's model exactly.
* ``backend="auto"``'s cache hit is resolved once and replayed until the
  cache's next write: every hit is still counted, and an entry put, dropped
  or cleared is looked up anew (a bad one raises on every call).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core.tucker
import repro.verify.comm
import repro_torch
from repro_torch.convert import factors_from_numpy
from repro_torch.core.tensor import frob_norm
from repro_torch.core.tucker import hosvd_init
from repro_torch.engine.plan import MTTKRPKernelPlan, Memory
from repro_torch.observe.metrics import TUNE_CACHE_HITS, TUNE_CACHE_MISSES, registry
from repro_torch.tune import cache as tcache
from repro_torch.tune import search
from repro_torch.verify import comm
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


def _names(fn) -> list:
    return list(inspect.signature(fn).parameters)


@pytest.mark.parametrize("call", ["positional", "keyword"])
def test_hosvd_init_takes_the_reference_dtype(call):
    assert _names(hosvd_init) == _names(repro.core.tucker.hosvd_init)
    x, _ = data((9, 8, 7), 1, seed=11)
    ranks = (3, 2, 4)
    if call == "positional":
        got = hosvd_init(torch.from_numpy(x), ranks, torch.float32)
        want = repro.core.tucker.hosvd_init(jnp.asarray(x), ranks, jnp.float32)
    else:
        got = hosvd_init(torch.from_numpy(x), ranks=ranks, dtype=torch.bfloat16)
        want = repro.core.tucker.hosvd_init(jnp.asarray(x), ranks=ranks, dtype=jnp.bfloat16)
    for u, w in zip(got, want):
        w = np.asarray(w)
        assert u.dtype == torch.float32 and u.shape == w.shape  # x's dtype, not dtype's
        proj = (u @ u.T).numpy()
        assert float(np.abs(proj - w @ w.T).max()) <= 1e-4


@pytest.mark.parametrize("overlap", comm.OVERLAPS)
def test_check_tucker_sweep_takes_ranks_by_keyword(overlap):
    assert _names(comm.check_tucker_sweep) == _names(repro.verify.comm.check_tucker_sweep)
    dims, ranks, grid = (8, 8, 8), (4, 4, 4), (2, 2, 1)
    findings, v = comm.check_tucker_sweep(dims, ranks=ranks, grid=grid, overlap=overlap)
    assert findings == [] and v["agrees"] and v["rank"] == list(ranks)
    assert v["measured_collective_bytes"] == repro.verify.comm.tucker_sweep_model_bytes(
        dims, ranks=ranks, grid=grid)
    assert (findings, v) == comm.check_tucker_sweep(dims, ranks, grid, overlap)


@pytest.fixture
def port_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "port.json"))
    return tcache.default_cache()


def _key(kind="mttkrp"):
    return tcache.cache_key((16, 12, 8), 4, 0, torch.float32, Memory.h100_smem(), kind=kind,
                            device="cpu")


def _resolve():
    return search.resolve((16, 12, 8), 4, 0, torch.float32, device="cpu")


def _counts(before) -> tuple:
    delta = registry().delta(before)
    return delta.get(TUNE_CACHE_HITS, 0), delta.get(TUNE_CACHE_MISSES, 0)


GOOD = MTTKRPKernelPlan(64, 16, 16, 2)


def test_a_cache_hit_is_replayed_and_every_hit_counted(port_cache):
    port_cache.put(_key(), tcache.CacheEntry("cuda", tcache.plan_to_dict(GOOD)))
    before = registry().snapshot()
    first, second, third = _resolve(), _resolve(), _resolve()
    assert first.cache_hit and first.plan == GOOD and first.backend == "cuda"
    assert second is first and third is first  # no new plan, no new check
    assert _counts(before) == (3, 0)
    ctx = repro_torch.ExecutionContext.create("auto", device="cpu")
    x, fs = data((16, 12, 8), 4, seed=2)
    for _ in range(2):
        repro_torch.mttkrp(torch.from_numpy(x), [torch.from_numpy(f) for f in fs], 0, ctx=ctx)
    assert _counts(before) == (5, 0)


@pytest.mark.parametrize("write", ["put", "invalidate", "clear"])
def test_a_write_drops_the_replayed_hits(port_cache, write):
    port_cache.put(_key(), tcache.CacheEntry("cuda", tcache.plan_to_dict(GOOD)))
    assert _resolve().plan == GOOD
    if write == "put":  # a hand-edited entry replacing a good one raises from now on
        port_cache.put(_key(), tcache.CacheEntry("cuda", tcache.plan_to_dict(
            MTTKRPKernelPlan(96, 16, 16, 2))))
        for _ in range(2):
            with pytest.raises(ValueError, match="refused"):
                _resolve()
        return
    getattr(port_cache, write)(*([_key()] if write == "invalidate" else []))
    before = registry().snapshot()
    got = _resolve()
    assert not got.cache_hit and got.backend == "einsum" and _counts(before) == (0, 1)


def test_replayed_hits_are_kept_apart_by_kind(port_cache):
    port_cache.put(_key("sweep").replace("mode=0", "mode=-1"),
                   tcache.CacheEntry("auto", variant="per_mode"))
    port_cache.put(_key(), tcache.CacheEntry("cuda", tcache.plan_to_dict(GOOD)))
    for _ in range(2):
        assert search.resolve_sweep((16, 12, 8), 4, torch.float32, device="cpu").variant \
            == "per_mode"
        assert _resolve().plan == GOOD
        assert not search.resolve((16, 12, 8), 4, 0, torch.float32, kind="partial",
                                  device="cpu").cache_hit
