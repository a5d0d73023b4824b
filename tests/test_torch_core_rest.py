"""The rest of ``repro.core`` in the port, against the reference, on the CPU.

The same numpy inputs (made from a seed) go through ``repro`` (JAX) and
``repro_torch`` (PyTorch). Tolerances:

* ``dematricize`` and ``np_matricize`` move elements only: equal.
* ``relative_error`` and ``mttkrp_all_modes`` sum in float32 in another
  order: within 1e-6 of the largest magnitude.
* The grid choosers are integer searches and the simulators count words:
  equal, exactly.
* ``cp_gradient`` from the reference's ``random_factors`` start: in float64
  (the reference under a scoped ``jax.enable_x64``) the factors within
  1e-10 of their largest magnitude, and the fits within 1e-10 given the
  same ||X|| (both packages round it to float32, each in its own summation
  order, which alone moves a fit by about 1e-7: within 1e-6); in float32
  the fits within 1e-4 and the factors within 1e-3 of their largest
  magnitude after 60 Adam steps: Adam divides each step by sqrt(v_hat),
  which turns float32 rounding in the gradient (1e-7 of it) into changes of
  up to lr * 1e-3 a step where v_hat is small, and those add up over the
  steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core.blocked as jblocked
import repro.core.grid as jgrid
import repro.core.simulator as jsim
import repro.core.tensor as jtensor
from repro.core.mttkrp import mttkrp as j_mttkrp, mttkrp_all_modes as j_all_modes
import repro_torch
import repro_torch.core.blocked as tblocked
import repro_torch.core.grid as tgrid
import repro_torch.core.mttkrp as tmttkrp
import repro_torch.core.simulator as tsim
import repro_torch.core.tensor as ttensor
from repro_torch.convert import factors_from_numpy
from repro_torch.engine.plan import Memory

from _torch_parity import close, data, port_cp, problem

SHAPES = [(5, 7, 9), (12, 1, 6), (4, 5, 6, 3), (3, 4, 2, 5, 3)]


# -- core/tensor.py -----------------------------------------------------------

@pytest.mark.parametrize("dims", SHAPES)
def test_dematricize_inverts_matricize_as_the_reference(dims):
    x, _ = data(dims, 1, seed=1)
    for mode in range(len(dims)):
        xm = ttensor.matricize(torch.from_numpy(x), mode)
        got = ttensor.dematricize(xm, mode, dims)
        want = jtensor.dematricize(jnp.asarray(xm.numpy()), mode, dims)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("dims", SHAPES)
def test_np_matricize_is_the_reference_copy(dims):
    x, _ = data(dims, 1, seed=2)
    for mode in range(len(dims)):
        got = ttensor.np_matricize(x, mode)
        np.testing.assert_array_equal(got, jtensor.np_matricize(x, mode))
        np.testing.assert_array_equal(got, ttensor.matricize(torch.from_numpy(x), mode).numpy())


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_relative_error_matches_reference(scale):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 5, 4), dtype=np.float32)
    y = (x + scale * rng.standard_normal(x.shape)).astype(np.float32)
    got = ttensor.relative_error(torch.from_numpy(x), torch.from_numpy(y))
    want = float(jtensor.relative_error(jnp.asarray(x), jnp.asarray(y)))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * max(want, 1e-30) + 1e-12


def test_random_tensor_draws_from_its_generator():
    a = ttensor.random_tensor(torch.Generator().manual_seed(4), (3, 4, 5))
    b = ttensor.random_tensor(torch.Generator().manual_seed(4), (3, 4, 5))
    assert a.shape == (3, 4, 5) and a.dtype == torch.float32
    assert torch.equal(a, b)
    c = ttensor.random_tensor(torch.Generator().manual_seed(5), (3, 4, 5), torch.float64)
    assert c.dtype == torch.float64 and not torch.equal(a.double(), c)


# -- core/mttkrp.py and core/blocked.py ---------------------------------------

@pytest.mark.parametrize("dims", SHAPES)
def test_mttkrp_all_modes_matches_reference(dims):
    x, fs = data(dims, 4, seed=6)
    got = tmttkrp.mttkrp_all_modes(torch.from_numpy(x), factors_from_numpy(fs, "cpu"))
    want = j_all_modes(jnp.asarray(x), [jnp.asarray(f) for f in fs])
    assert len(got) == len(want) == len(dims)
    for g, w in zip(got, want):
        close(g, w, tol=1e-6)


@pytest.mark.parametrize("block", [1, 2, 3, 8])
@pytest.mark.parametrize("dims", SHAPES[:3])
def test_mttkrp_blocked_reference_check_matches_reference(dims, block):
    x, fs = data(dims, 3, seed=7)
    for mode in range(len(dims)):
        got = tblocked.mttkrp_blocked_reference_check(torch.from_numpy(x),
                                                      factors_from_numpy(fs, "cpu"), mode, block)
        want = float(jblocked.mttkrp_blocked_reference_check(
            jnp.asarray(x), [jnp.asarray(f) for f in fs], mode, block))
        scale = float(np.abs(np.asarray(j_mttkrp(jnp.asarray(x), [jnp.asarray(f) for f in fs],
                                                mode))).max())
        # both discrepancies are float32 rounding of the same sums
        assert got.ndim == 0 and float(got) <= 1e-6 * scale and want <= 1e-6 * scale


# -- core/grid.py ---------------------------------------------------------------

GRID_DIMS = [(8, 8, 8), (100, 10, 10), (16, 64, 4), (7, 11, 13), (32, 32, 32, 32),
             (5, 100, 20, 3), (1000, 1000)]


@pytest.mark.parametrize("procs", [1, 2, 6, 8, 12, 16, 30, 64])
@pytest.mark.parametrize("dims", GRID_DIMS)
def test_grids_equal_the_reference(dims, procs):
    assert tgrid.stationary_grid(dims, procs) == jgrid.stationary_grid(dims, procs)
    for rank in (1, 4, 32, 100):
        for allow in (True, False):
            assert (tgrid.paper_grid(dims, rank, procs, allow)
                    == jgrid.paper_grid(dims, rank, procs, allow))
        for mode in range(len(dims)):
            assert (tgrid.optimal_grid(dims, rank, procs, mode)
                    == jgrid.optimal_grid(dims, rank, procs, mode))


# -- core/simulator.py ----------------------------------------------------------

def _sim_problem(dims, rank, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(dims), [rng.standard_normal((d, rank)) for d in dims])


def _same_sim(got, want):
    assert (got.loads, got.stores, got.peak_fast_words, got.mem, got.words) == (
        want.loads, want.stores, want.peak_fast_words, want.mem, want.words)
    np.testing.assert_allclose(got.output, want.output, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dims,rank", [((4, 5, 3), 2), ((3, 3, 3, 2), 3), ((6, 2, 5), 1)])
def test_simulate_unblocked_counts_equal_the_reference(dims, rank):
    x, fs = _sim_problem(dims, rank, 8)
    for mode in range(len(dims)):
        _same_sim(tsim.simulate_unblocked(x, fs, mode, mem=32),
                  jsim.simulate_unblocked(x, fs, mode, mem=32))


@pytest.mark.parametrize("mem,block", [(40, None), (40, 2), (80, 3), (200, None), (200, 4)])
@pytest.mark.parametrize("dims,rank", [((7, 5, 6), 2), ((5, 4, 3, 4), 2)])
def test_simulate_blocked_counts_equal_the_reference(dims, rank, mem, block):
    x, fs = _sim_problem(dims, rank, 9)
    for mode in range(len(dims)):
        try:
            want = jsim.simulate_blocked(x, fs, mode, mem, block)
        except ValueError as err:  # an infeasible block: the port refuses it too
            with pytest.raises(ValueError, match="infeasible"):
                tsim.simulate_blocked(x, fs, mode, mem, block)
            assert "infeasible" in str(err)
            continue
        _same_sim(tsim.simulate_blocked(x, fs, mode, mem, block), want)


def test_simulators_take_the_context_memory():
    x, fs = _sim_problem((6, 5, 4), 2, 10)
    tctx = repro_torch.ExecutionContext.create("einsum", memory=Memory.abstract(60),
                                               device="cpu")
    jctx = repro.ExecutionContext.create(backend="einsum",
                                         memory=repro.Memory.abstract(60))
    _same_sim(tsim.simulate_blocked(x, fs, 1, ctx=tctx), jsim.simulate_blocked(x, fs, 1, ctx=jctx))
    _same_sim(tsim.simulate_unblocked(x, fs, 2, ctx=tctx),
              jsim.simulate_unblocked(x, fs, 2, ctx=jctx))


def test_simulator_errors_match_the_reference():
    x, fs = _sim_problem((4, 4, 4), 2, 11)
    tctx = repro_torch.ExecutionContext.create("einsum", memory=Memory.abstract(60),
                                               device="cpu")
    jctx = repro.ExecutionContext.create(backend="einsum", memory=repro.Memory.abstract(60))
    bare_t = repro_torch.ExecutionContext.create("einsum", device="cpu")
    bare_j = repro.ExecutionContext.create(backend="einsum")
    cases = [  # (call of each package, error type, message)
        (lambda m: m.simulate_blocked(x, fs, 0, mem=60, ctx=None), None, None),
        (lambda m: m.simulate_unblocked(x, fs, 0), ValueError, "no fast-memory size"),
        (lambda m: m.simulate_blocked(x, fs, 0, block=4, mem=16), ValueError, "infeasible"),
        (lambda m: m.simulate_unblocked(x, fs, 0, mem=3), ValueError, "at least N\\+2"),
    ]
    for call, err, match in cases:
        if err is None:
            _same_sim(call(tsim), call(jsim))
            continue
        for mod in (tsim, jsim):
            with pytest.raises(err, match=match):
                call(mod)
    for mod, ctx in ((tsim, tctx), (jsim, jctx)):
        with pytest.raises(ValueError, match="either mem= or a ctx"):
            mod.simulate_blocked(x, fs, 0, mem=60, ctx=ctx)
    for mod, ctx in ((tsim, bare_t), (jsim, bare_j)):
        with pytest.raises(ValueError, match="no fast-memory size"):
            mod.simulate_blocked(x, fs, 0, ctx=ctx)


def test_simulator_capacity_is_enforced_as_in_the_reference():
    x, fs = _sim_problem((3, 3, 3), 2, 12)
    for mod in (tsim, jsim):
        with pytest.raises(MemoryError, match="fast memory overflow"):
            fm = mod._FastMemory(4)
            fm.acquire(3)
            fm.acquire(2)
    _same_sim(tsim.simulate_unblocked(x, fs, 0, mem=5), jsim.simulate_unblocked(x, fs, 0, mem=5))


# -- core/cp_als.py: cp_gradient, mttkrp_fn, use_dimension_tree ------------------

def _ref_start(dims, rank, dtype):
    """The reference's own start, ``random_factors(PRNGKey(0), ...)``."""
    return [np.asarray(f) for f in jtensor.random_factors(jax.random.PRNGKey(0), dims, rank,
                                                          dtype)]


def test_cp_gradient_float64_matches_reference_under_x64(monkeypatch):
    x, _ = problem((7, 6, 5), 2, 13)
    x = x.astype(np.float64)
    with jax.enable_x64(True):
        init = _ref_start(x.shape, 3, jnp.float64)
        ref = repro.cp_gradient(jnp.asarray(x), 3, 40, 0.05, key=jax.random.PRNGKey(0),
                                ctx=repro.ExecutionContext.create(backend="einsum"))
        ref_fits, ref_factors = list(ref.fits), [np.asarray(f) for f in ref.factors]
        ref_norm = float(jtensor.frob_norm(jnp.asarray(x)))

    def run():
        return repro_torch.cp_gradient(
            torch.from_numpy(x), 3, 40, 0.05, init_factors=factors_from_numpy(init, "cpu"),
            ctx=repro_torch.ExecutionContext.create("einsum", device="cpu"))

    got = run()
    assert all(f.dtype == torch.float64 for f in got.factors)
    for a, b in zip(got.factors, ref_factors):
        assert float(np.abs(a.numpy() - b).max()) <= 1e-10 * float(np.abs(b).max())
    # each package rounds ||X|| to float32 in its own summation order (here
    # one float32 ulp apart), which moves a fit by about 1e-7
    np.testing.assert_allclose(got.fits, ref_fits, rtol=0, atol=1e-6)
    # with the reference's float32 norm the fits agree to float64 rounding
    import repro_torch.core.cp_als as tcp

    monkeypatch.setattr(tcp, "frob_norm", lambda t: torch.tensor(ref_norm, dtype=torch.float32))
    np.testing.assert_allclose(run().fits, ref_fits, rtol=0, atol=1e-10)


@pytest.mark.parametrize("backend", ["einsum", "blocked_host", "cuda"])
def test_cp_gradient_float32_matches_reference(backend):
    x, _ = problem((8, 7, 6), 2, 14)
    init = _ref_start(x.shape, 2, jnp.float32)
    ref = repro.cp_gradient(jnp.asarray(x), 2, 60, 0.05, key=jax.random.PRNGKey(0),
                            ctx=repro.ExecutionContext.create(backend="einsum"))
    got = repro_torch.cp_gradient(torch.from_numpy(x), 2, 60, 0.05,
                                  init_factors=factors_from_numpy(init, "cpu"),
                                  ctx=repro_torch.ExecutionContext.create(backend, device="cpu"))
    assert len(got.fits) == len(ref.fits) == 6
    np.testing.assert_allclose(got.fits, list(ref.fits), rtol=0, atol=1e-4)
    for a, b in zip(got.factors, ref.factors):
        b = np.asarray(b)
        assert float(np.abs(a.numpy() - b).max()) <= 1e-3 * float(np.abs(b).max())
    np.testing.assert_array_equal(got.weights.numpy(), np.ones(2, np.float32))


def test_cp_gradient_draws_from_its_generator():
    x = torch.from_numpy(problem((6, 5, 4), 2, 15)[0])
    ctx = repro_torch.ExecutionContext.create("einsum", device="cpu")
    a = repro_torch.cp_gradient(x, 2, 10, generator=torch.Generator().manual_seed(3), ctx=ctx)
    b = repro_torch.cp_gradient(x, 2, 10, generator=torch.Generator().manual_seed(3), ctx=ctx)
    assert a.fits == b.fits and len(a.fits) == 1


@pytest.mark.parametrize("driver", ["cp_als", "cp_gradient"])
def test_mttkrp_fn_is_called_n_times_an_iteration(driver):
    x, init = problem((6, 5, 4), 2, 16)
    calls = []

    def fn(t, fs, mode):
        calls.append(mode)
        return repro_torch.mttkrp(t, fs, mode, ctx=repro_torch.ExecutionContext.create(
            "einsum", device="cpu"))

    ctx = repro_torch.ExecutionContext.create("cuda", device="cpu")
    run = getattr(repro_torch, driver)
    res = run(torch.from_numpy(x), 2, 10, init_factors=factors_from_numpy(init, "cpu"),
              mttkrp_fn=fn, ctx=ctx)
    # cp_als: N a sweep; cp_gradient: N a step and one more for each fit
    extra = len(res.fits) if driver == "cp_gradient" else 0
    assert len(calls) == 3 * 10 + extra
    assert calls[:6] == [0, 1, 2, 0, 1, 2]
    plain = run(torch.from_numpy(x), 2, 10, init_factors=factors_from_numpy(init, "cpu"),
                ctx=ctx)
    np.testing.assert_allclose(res.fits, plain.fits, rtol=0, atol=1e-5)


def test_mttkrp_fn_matches_the_reference_override():
    x, init = problem((6, 5, 4), 2, 17)

    def jfn(t, fs, mode):
        return repro.mttkrp(t, fs, mode, ctx=repro.ExecutionContext.create(backend="einsum"))

    def tfn(t, fs, mode):
        return 2.0 * repro_torch.mttkrp(t, fs, mode, ctx=repro_torch.ExecutionContext.create(
            "einsum", device="cpu"))

    ref = repro.cp_als(jnp.asarray(x), 2, 4, init_factors=[jnp.asarray(f) for f in init],
                       mttkrp_fn=lambda t, fs, m: 2.0 * jfn(t, fs, m),
                       ctx=repro.ExecutionContext.create(backend="einsum"))
    got = repro_torch.cp_als(torch.from_numpy(x), 2, 4,
                             init_factors=factors_from_numpy(init, "cpu"), mttkrp_fn=tfn,
                             ctx=repro_torch.ExecutionContext.create("einsum", device="cpu"))
    np.testing.assert_allclose(got.fits, list(ref.fits), rtol=0, atol=1e-5)


def test_use_dimension_tree_is_the_dimtree_sweep():
    x, init = problem((6, 5, 4, 3), 2, 18)
    ctx = repro_torch.ExecutionContext.create("cuda", device="cpu")
    alias = repro_torch.cp_als(torch.from_numpy(x), 2, 3, use_dimension_tree=True,
                               init_factors=factors_from_numpy(init, "cpu"), ctx=ctx)
    tree = port_cp(x, init, 2, 3, "dimtree")
    assert alias.fits == tree.fits
    ref = repro.cp_als(jnp.asarray(x), 2, 3, init_factors=[jnp.asarray(f) for f in init],
                       use_dimension_tree=True,
                       ctx=repro.ExecutionContext.create(backend="einsum"))
    np.testing.assert_allclose(alias.fits, list(ref.fits), rtol=0, atol=1e-5)


@pytest.mark.parametrize("sweep", ["per_mode", "fused", "auto"])
def test_use_dimension_tree_conflicts_as_in_the_reference(sweep):
    x, init = problem((5, 4, 3), 2, 19)
    for call in (
        lambda: repro_torch.cp_als(torch.from_numpy(x), 2, 1, use_dimension_tree=True,
                                   sweep=sweep, ctx=repro_torch.ExecutionContext.create(
                                       "einsum", device="cpu")),
        lambda: repro.cp_als(jnp.asarray(x), 2, 1, use_dimension_tree=True, sweep=sweep,
                             ctx=repro.ExecutionContext.create(backend="einsum")),
    ):
        with pytest.raises(ValueError, match="conflicts with use_dimension_tree=True"):
            call()
    # sweep="dimtree" beside the alias is no conflict
    repro_torch.cp_als(torch.from_numpy(x), 2, 1, use_dimension_tree=True, sweep="dimtree",
                       ctx=repro_torch.ExecutionContext.create("einsum", device="cpu"))


def test_the_new_names_are_exported():
    for name in ("cp_gradient", "cp_als_batched", "tucker_hooi_batched", "BatchedCPResult",
                 "BatchedTuckerResult"):
        assert name in repro_torch.__all__ and hasattr(repro, name)
