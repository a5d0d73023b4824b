"""The port's batched engine against loops and against the reference, on the
CPU (the counterpart of ``tests/test_batched.py``).

Every batched entry point (a leading batch axis on ``mttkrp``,
``contract_partial`` and ``multi_ttm``) must equal a Python loop of
unbatched calls within ``rtol=1e-6, atol=1e-6``, and the reference's batched
call on the same numpy inputs within 1e-6 of the result's largest magnitude
(``_torch_parity.close``): JAX and torch sum in float32 in other orders,
which moves an entry small beside the result's largest by more than 1e-6 of
itself (2.5e-6 at an entry of 0.47 in a 4-way result of magnitude 12), so
the reference comparison cannot be element by element. On the
``cuda`` backend CPU tensors take the kernels' plain versions. The batched
drivers are held against the reference's batched drivers and against loops
of the port's unbatched drivers at the reference's tolerances
(``tests/test_batched.py``: factors and weights ``rtol=1e-4, atol=1e-5``,
fits ``1e-5``). The kernels' batched plans and grids, the batch-stride
width rule and the one-launch-per-call structure are checked here in pure
Python; the launches themselves on the card (``tests/test_torch_cuda.py``).
The reference's tune-cache amortization test is in ``tests/test_torch_tune.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.engine.batch import batched_choose_blocks as j_batched_choose_blocks
from repro_torch.engine.batch import batched_choose_blocks
from repro_torch.engine.plan import (
    H100_SMS,
    Memory,
    choose_blocks,
    choose_mttkrp_kernel_blocks,
    choose_multi_ttm_kernel_blocks,
    choose_partial_kernel_blocks,
    mttkrp_kernel_grid,
    multi_ttm_kernel_grid,
)
from repro_torch.kernels import ops, partial, splitk

from _torch_parity import close

BACKENDS = ("einsum", "blocked_host", "cuda")
TOL = dict(rtol=1e-6, atol=1e-6)


def _ctx(backend):
    return repro_torch.ExecutionContext.create(backend, device="cpu")


def _jctx(backend="einsum"):
    if backend == "pallas":
        return repro.ExecutionContext.create(backend="pallas", interpret=True,
                                             memory=repro.Memory.abstract(2 ** 16))
    return repro.ExecutionContext.create(backend=backend)


def _batch(batch, dims, rank, seed=0, shared=False):
    """A ``(B, *dims)`` numpy tensor and per-element (or shared) factors."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, *dims), dtype=np.float32)
    lead = () if shared else (batch,)
    return x, [rng.standard_normal((*lead, d, rank), dtype=np.float32) for d in dims]


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _elem(a, b):
    return None if a is None else (a[b] if a.ndim == 3 else a)


CASES = [  # (B, dims, R)
    (1, (4, 5, 3), 2), (3, (5, 4, 6), 3), (4, (2, 7, 3), 1), (2, (3, 4, 2, 5), 4),
    (5, (6, 3, 5), 5), (3, (7, 6), 2),
]


# -- differential: batched == loop == the reference's batched call --------------

@pytest.mark.parametrize("shared", [False, True], ids=["per_element", "shared"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("batch,dims,rank", CASES)
def test_batched_mttkrp_equals_loop_and_reference(batch, dims, rank, backend, shared):
    x, fs = _batch(batch, dims, rank, seed=1, shared=shared)
    ctx = _ctx(backend)
    for mode in range(len(dims)):
        out = repro_torch.mttkrp(_t(x), [_t(f) for f in fs], mode, ctx=ctx)
        assert out.shape == (batch, dims[mode], rank)
        loop = torch.stack([repro_torch.mttkrp(_t(x[b]), [_t(_elem(f, b)) for f in fs], mode,
                                               ctx=ctx) for b in range(batch)])
        np.testing.assert_allclose(out.numpy(), loop.numpy(), **TOL)
        want = repro.mttkrp(_j(x), [_j(f) for f in fs], mode, ctx=_jctx())
        close(out, want, tol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("keep", [None, 0, 1, 2])
@pytest.mark.parametrize("batch,dims", [(1, (4, 5, 3)), (3, (5, 4, 6)), (2, (2, 6, 3))])
def test_batched_multi_ttm_equals_loop_and_reference(batch, dims, keep, backend):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((batch, *dims), dtype=np.float32)
    mats = [None if k == keep else
            rng.standard_normal(((batch,) if k % 2 == 0 else ()) + (d, min(2, d)),
                                dtype=np.float32)  # per-element and shared mixed
            for k, d in enumerate(dims)]
    ctx = _ctx(backend)
    out = repro_torch.multi_ttm(_t(x), [_t(m) for m in mats], keep, ctx=ctx)
    loop = torch.stack([repro_torch.multi_ttm(_t(x[b]), [_t(_elem(m, b)) for m in mats], keep,
                                              ctx=ctx) for b in range(batch)])
    np.testing.assert_allclose(out.numpy(), loop.numpy(), **TOL)
    want = repro.multi_ttm(_j(x), [_j(m) for m in mats], keep, ctx=_jctx())
    close(out, want, tol=1e-6)


def _edges(n):
    """Tree edges: (modes, drop, has_rank) of a node without and with a rank
    axis, as the dimension tree and the fused sweep contract them."""
    full = tuple(range(n))
    return [(full, (n - 1,), False), (full, (0,), False), (full, (0, n - 1), False),
            (full, (1,), True), ((0, n - 1), (n - 1,), True), ((1,), (1,), True)]


@pytest.mark.parametrize("shared", [False, True], ids=["per_element", "shared"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("batch,dims,rank", [(2, (4, 5, 3), 2), (3, (3, 4, 2, 5), 3),
                                             (1, (6, 5, 4), 4)])
def test_batched_contract_partial_equals_loop_and_reference(batch, dims, rank, backend,
                                                            shared):
    x, fs = _batch(batch, dims, rank, seed=3, shared=shared)
    rng = np.random.default_rng(4)
    ctx = _ctx(backend)
    for modes, drop, has_rank in _edges(len(dims)):
        shape = tuple(dims[m] for m in modes) + ((rank,) if has_rank else ())
        node = x if len(modes) == len(dims) and not has_rank else rng.standard_normal(
            (batch, *shape), dtype=np.float32)
        out = repro_torch.contract_partial(_t(node), [_t(f) for f in fs], modes, drop,
                                           has_rank, ctx=ctx)
        loop = torch.stack([
            repro_torch.contract_partial(_t(node[b]), [_t(_elem(f, b)) for f in fs], modes,
                                         drop, has_rank, ctx=ctx) for b in range(batch)])
        np.testing.assert_allclose(out.numpy(), loop.numpy(), **TOL)
        want = repro.contract_partial(_j(node), [_j(f) for f in fs], modes, drop, has_rank,
                                      ctx=_jctx())
        close(out, want, tol=1e-6)


def test_batched_calls_match_the_reference_pallas_path():
    """The kernels' plain versions (``cuda`` on CPU tensors) against the
    reference's vmapped Pallas kernels in interpret mode."""
    x, fs = _batch(3, (6, 5, 4), 3, seed=5)
    ctx = _ctx("cuda")
    for mode in range(3):
        close(repro_torch.mttkrp(_t(x), [_t(f) for f in fs], mode, ctx=ctx),
              repro.mttkrp(_j(x), [_j(f) for f in fs], mode, ctx=_jctx("pallas")), tol=1e-6)
    mats = [f[..., :2] for f in fs]
    close(repro_torch.multi_ttm(_t(x), [_t(m) for m in mats], None, ctx=ctx),
          repro.multi_ttm(_j(x), [_j(m) for m in mats], None, ctx=_jctx("pallas")), tol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_bf16_policy_matches_the_loop(backend):
    x, fs = _batch(3, (6, 5, 4), 3, seed=6)
    ctx = repro_torch.ExecutionContext.create(backend, compute_dtype="bfloat16", device="cpu")
    out = repro_torch.mttkrp(_t(x), [_t(f) for f in fs], 1, ctx=ctx)
    assert out.dtype == torch.float32
    loop = torch.stack([repro_torch.mttkrp(_t(x[b]), [_t(f[b]) for f in fs], 1, ctx=ctx)
                        for b in range(3)])
    np.testing.assert_allclose(out.numpy(), loop.numpy(), **TOL)


# -- shapes: shared factors broadcast, mismatches raise ---------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_shared_factors_broadcast(backend):
    x, fs = _batch(3, (5, 4, 6), 2, seed=8, shared=True)
    ctx = _ctx(backend)
    out = repro_torch.mttkrp(_t(x), [_t(f) for f in fs], 1, ctx=ctx)
    tiled = repro_torch.mttkrp(_t(x), [_t(f).expand(3, *f.shape) for f in fs], 1, ctx=ctx)
    np.testing.assert_allclose(out.numpy(), tiled.numpy(), **TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_shape_mismatch_raises(backend):
    x, fs = _batch(2, (4, 4, 4), 3, seed=9)
    ctx = _ctx(backend)
    bad = [_t(fs[0]), _t(fs[1][:, :3]), _t(fs[2])]  # wrong extent on mode 1
    with pytest.raises(ValueError, match="batched call"):
        repro_torch.mttkrp(_t(x), bad, 0, ctx=ctx)
    with pytest.raises(ValueError, match="batched call"):
        repro.mttkrp(_j(x), [_j(fs[0]), _j(fs[1][:, :3]), _j(fs[2])], 0)
    with pytest.raises(ValueError, match="batched call"):  # a batch of 3 factors for 2
        repro_torch.mttkrp(_t(x), [_t(np.concatenate([fs[0], fs[0][:1]])), _t(fs[1]),
                                   _t(fs[2])], 0, ctx=ctx)
    with pytest.raises(ValueError, match="batched call"):
        repro_torch.contract_partial(_t(x), [_t(f) for f in fs[:2]] + [_t(fs[2][:, :2])],
                                     (0, 1, 2), (2,), False, ctx=ctx)
    mats = [None, _t(fs[1]), _t(fs[2][..., :2, :])]
    with pytest.raises(ValueError):
        repro_torch.multi_ttm(_t(x), mats, 0, ctx=ctx)


# -- the batched drivers --------------------------------------------------------

def _cp_inits(batch, dims, rank, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, d, rank), dtype=np.float32) / np.sqrt(rank)
            for d in dims]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("batch,dims,rank", [(1, (5, 4, 6), 2), (3, (6, 5, 4), 3),
                                             (2, (4, 3, 5, 3), 2)])
def test_cp_als_batched_equals_reference_and_loop(batch, dims, rank, backend):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((batch, *dims), dtype=np.float32)
    inits = _cp_inits(batch, dims, rank, 11)
    res = repro_torch.cp_als_batched(_t(x), rank, 3, init_factors=[_t(f) for f in inits],
                                     ctx=_ctx(backend))
    assert res.batch == batch and res.ranks == (rank,) * len(dims)
    ref = repro.cp_als_batched(_j(x), rank, n_iters=3, init_factors=[_j(f) for f in inits],
                               ctx=_jctx())
    for k in range(len(dims)):
        np.testing.assert_allclose(res.factors[k].numpy(), np.asarray(ref.factors[k]),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.weights.numpy(), np.asarray(ref.weights), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(res.fits.numpy(), np.asarray(ref.fits), rtol=1e-5, atol=1e-5)
    for b in range(batch):
        single = repro_torch.cp_als(_t(x[b]), rank, 3, init_factors=[_t(f[b]) for f in inits],
                                    ctx=_ctx(backend))
        for k in range(len(dims)):
            np.testing.assert_allclose(res.factors[k][b].numpy(), single.factors[k].numpy(),
                                       rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res.weights[b].numpy(), single.weights.numpy(), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(float(res.fits[b]), single.fits[-1], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res.result(b).fits, single.fits, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("batch,dims,ranks", [(3, (7, 6, 5), (3, 2, 2)), (1, (5, 6, 4), (2, 3, 2)),
                                              (2, (4, 5, 3, 4), (2, 2, 2, 3))])
def test_tucker_hooi_batched_equals_reference_and_loop(batch, dims, ranks, backend):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((batch, *dims), dtype=np.float32)
    res = repro_torch.tucker_hooi_batched(_t(x), ranks, 3, ctx=_ctx(backend))
    assert res.batch == batch and res.ranks == ranks
    ref = repro.tucker_hooi_batched(_j(x), ranks, n_iters=3, ctx=_jctx())
    np.testing.assert_allclose(res.core.numpy(), np.asarray(ref.core), rtol=1e-4, atol=1e-5)
    for k in range(len(dims)):
        np.testing.assert_allclose(res.factors[k].numpy(), np.asarray(ref.factors[k]),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.fits.numpy(), np.asarray(ref.fits), rtol=1e-5, atol=1e-5)
    for b in range(batch):
        single = repro_torch.tucker_hooi(_t(x[b]), ranks, 3, ctx=_ctx(backend))
        one = res.result(b)
        np.testing.assert_allclose(one.core.numpy(), single.core.numpy(), rtol=1e-4, atol=1e-5)
        for k in range(len(dims)):
            np.testing.assert_allclose(one.factors[k].numpy(), single.factors[k].numpy(),
                                       rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(one.fits[-1], single.fits[-1], rtol=1e-5, atol=1e-5)


def test_tucker_hooi_batched_from_init_factors_and_without_sweeps():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 6, 5, 4), dtype=np.float32)
    ranks = (2, 2, 2)
    start = repro_torch.tucker_hooi_batched(_t(x), ranks, 0, ctx=_ctx("einsum"))
    for b in range(2):
        single = repro_torch.tucker_hooi(_t(x[b]), ranks, 0, ctx=_ctx("einsum"))
        np.testing.assert_allclose(start.core[b].numpy(), single.core.numpy(), rtol=1e-4,
                                   atol=1e-5)
    res = repro_torch.tucker_hooi_batched(_t(x), ranks, 2, init_factors=start.factors,
                                          ctx=_ctx("cuda"))
    ref = repro.tucker_hooi_batched(_j(x), ranks, n_iters=2,
                                    init_factors=[_j(f.numpy()) for f in start.factors])
    np.testing.assert_allclose(res.fits.numpy(), np.asarray(ref.fits), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="init_factors"):
        repro_torch.tucker_hooi_batched(_t(x), ranks, 1, ctx=_ctx("einsum"),
                                        init_factors=[f[:1] for f in start.factors])


def test_cp_als_batched_draws_each_element_as_cp_als_does():
    """The ``generator`` start: element b's factors are the b-th draw of
    ``random_factors``, so a loop of ``cp_als`` from the same generator's
    draws follows the same trajectories."""
    rng = np.random.default_rng(14)
    x = _t(rng.standard_normal((3, 5, 4, 6), dtype=np.float32))
    ctx = _ctx("einsum")
    res = repro_torch.cp_als_batched(x, 2, 3, generator=torch.Generator().manual_seed(7),
                                     ctx=ctx)
    gen = torch.Generator().manual_seed(7)
    for b in range(3):
        single = repro_torch.cp_als(x[b], 2, 3, generator=gen, ctx=ctx)
        np.testing.assert_allclose(res.result(b).fits, single.fits, rtol=1e-5, atol=1e-5)
    default = repro_torch.cp_als_batched(x, 2, 3, ctx=ctx)
    np.testing.assert_allclose(default.fits.numpy(), repro_torch.cp_als_batched(
        x, 2, 3, generator=torch.Generator().manual_seed(0), ctx=ctx).fits.numpy(), rtol=0,
        atol=0)


@pytest.mark.parametrize("driver", ["cp_als_batched", "tucker_hooi_batched"])
def test_drivers_refuse_a_batch_of_vectors_as_the_reference(driver):
    x = np.zeros((3, 4), np.float32)
    arg = 2 if driver == "cp_als_batched" else (2,)
    for run in (lambda: getattr(repro_torch, driver)(_t(x), arg, ctx=_ctx("einsum")),
                lambda: getattr(repro, driver)(_j(x), arg)):
        with pytest.raises(ValueError, match="needs a batch of >=2-way tensors"):
            run()


def test_convergence_mask_freezes_converged_elements():
    """An exactly low-rank element converges first; from then on its
    factors, weights, fit and counter stop changing, bit for bit, while the
    noisy element keeps iterating. (Its fit, near 1, sits at float32's
    floor, where the two packages' fits differ by rounding, so the sweep at
    which it stops is not compared with the reference's.)"""
    rng = np.random.default_rng(15)
    dims, rank = (6, 5, 4), 2
    true = [rng.standard_normal((d, rank)) for d in dims]
    clean = np.einsum("az,bz,cz->abc", *true).astype(np.float32)
    noisy = rng.standard_normal(dims, dtype=np.float32)
    x = _t(np.stack([clean, noisy]))
    start = np.random.default_rng(16)
    # element 0 starts near its true factors, element 1 anywhere
    inits = [_t(np.stack([t + 0.01 * start.standard_normal(t.shape),
                          start.standard_normal(t.shape)]).astype(np.float32)) for t in true]
    ctx = _ctx("einsum")
    res = repro_torch.cp_als_batched(x, rank, 40, init_factors=inits, tol=1e-6, ctx=ctx)
    stop = int(res.n_iters[0])
    assert bool(res.converged[0]) and stop < int(res.n_iters[1])
    assert len(res.fit_history) == int(res.n_iters.max())
    for h in res.fit_history[stop - 1:]:
        assert float(h[0]) == float(res.fits[0])
    short = repro_torch.cp_als_batched(x, rank, stop, init_factors=inits, ctx=ctx)
    for k in range(3):
        assert torch.equal(res.factors[k][0], short.factors[k][0])
    assert torch.equal(res.weights[0], short.weights[0])


def test_tucker_convergence_mask_freezes_converged_elements():
    rng = np.random.default_rng(17)
    dims, ranks = (6, 5, 4), (2, 2, 2)
    core = rng.standard_normal(ranks)
    qs = [np.linalg.qr(rng.standard_normal((d, r)))[0] for d, r in zip(dims, ranks)]
    clean = np.einsum("abc,ia,jb,kc->ijk", core, *qs).astype(np.float32)
    noisy = rng.standard_normal(dims, dtype=np.float32)
    x = _t(np.stack([clean, noisy]))
    res = repro_torch.tucker_hooi_batched(x, ranks, 30, tol=1e-7, ctx=_ctx("einsum"))
    assert bool(res.converged[0])
    stop = int(res.n_iters[0])
    short = repro_torch.tucker_hooi_batched(x, ranks, stop, ctx=_ctx("einsum"))
    assert torch.equal(res.core[0], short.core[0])
    for k in range(3):
        assert torch.equal(res.factors[k][0], short.factors[k][0])


# -- one kernel call per batched call -----------------------------------------------

def _count(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_one_kernel_call_per_batched_call(monkeypatch):
    """On ``cuda`` a batched call reaches its kernel wrapper once (the card
    tests count the launches): the loop reaches it B times."""
    calls = _count(monkeypatch, ops, "mttkrp3")
    x, fs = _batch(5, (6, 5, 4), 3, seed=18)
    ctx = _ctx("cuda")
    repro_torch.mttkrp(_t(x), [_t(f) for f in fs], 0, ctx=ctx)
    assert len(calls) == 1
    for b in range(5):
        repro_torch.mttkrp(_t(x[b]), [_t(f[b]) for f in fs], 0, ctx=ctx)
    assert len(calls) == 6
    ttm = _count(monkeypatch, ops, "multi_ttm_keep")
    repro_torch.multi_ttm(_t(x), [_t(f[..., :2]) for f in fs], None, ctx=ctx)
    assert len(ttm) == 1
    part = _count(monkeypatch, ops, "mttkrp_partial")
    node = np.random.default_rng(19).standard_normal((5, 6, 4, 3), dtype=np.float32)
    repro_torch.contract_partial(_t(node), [_t(f) for f in fs], (0, 2), (2,), True, ctx=ctx)
    assert len(part) == 1


@pytest.mark.parametrize("batch", [1, 4])
def test_batched_cp_sweep_calls_the_kernel_n_times_an_iteration(monkeypatch, batch):
    calls = _count(monkeypatch, ops, "mttkrp3")
    rng = np.random.default_rng(20)
    x = _t(rng.standard_normal((batch, 6, 5, 4), dtype=np.float32))
    repro_torch.cp_als_batched(x, 2, 2, ctx=_ctx("cuda"))
    assert len(calls) == 3 * 2


def test_batched_hooi_sweep_calls_the_kernel_n_times_a_sweep(monkeypatch):
    calls = _count(monkeypatch, ops, "multi_ttm_keep")
    x = _t(np.random.default_rng(21).standard_normal((4, 6, 5, 4), dtype=np.float32))
    repro_torch.tucker_hooi_batched(x, (2, 2, 2), 2, ctx=_ctx("cuda"))
    assert len(calls) == 3 * 2


# -- plans: the element's, the split count alone sees B ----------------------------

@pytest.mark.parametrize("batch", [1, 2, 7, 16])
@pytest.mark.parametrize("shape,rank", [((4, 4, 4), 2), ((20, 33, 9), 7), ((64, 8, 50), 32),
                                        ((5, 6, 7, 8), 3)])
@pytest.mark.parametrize("has_rank", [False, True])
def test_batched_plan_is_the_element_plan(batch, shape, rank, has_rank):
    mem = Memory.abstract(2 ** 14)
    got = batched_choose_blocks(batch, shape, rank, 4, memory=mem, x_has_rank=has_rank)
    assert got == choose_blocks(shape, rank, 4, memory=mem, x_has_rank=has_rank)
    want = j_batched_choose_blocks(batch, shape, rank, 4, memory=repro.Memory.abstract(2 ** 14),
                                   x_has_rank=has_rank)
    assert (got.block_i, got.block_contract, got.block_r) == (
        want.block_i, tuple(want.block_contract), want.block_r)


def test_batched_choose_blocks_rejects_bad_batch():
    with pytest.raises(ValueError, match="batch"):
        batched_choose_blocks(0, (4, 4, 4), 2, 4)
    with pytest.raises(ValueError, match="batch"):
        j_batched_choose_blocks(0, (4, 4, 4), 2, 4)


@pytest.mark.parametrize("shape,rank", [((64, 64, 64), 16), ((256, 256, 256), 32),
                                        ((96, 96, 96), 16), ((64, 64, 64, 64), 16),
                                        ((1000, 1000, 1000), 64)])
def test_mttkrp_kernel_grid_splits_alone_see_the_batch(shape, rank):
    plan = choose_mttkrp_kernel_blocks(shape, rank, 4)
    rows, rtiles, s1 = mttkrp_kernel_grid(shape, rank, plan, H100_SMS)
    chunks = math.prod(shape[1:-1]) * math.ceil(shape[-1] / plan.block_k)
    prev = s1
    for batch in (1, 2, 16, 64, 264, 65535):
        r, t, s = mttkrp_kernel_grid(shape, rank, plan, H100_SMS, batch)
        assert (r, t) == (rows, rtiles) and 1 <= s <= prev
        # at least a wave of two CTAs an SM over the batch, unless the chunks run out
        assert rows * rtiles * batch * s >= 2 * H100_SMS or s == chunks
        prev = s
    assert mttkrp_kernel_grid(shape, rank, plan, H100_SMS, 2 * H100_SMS)[2] == 1


@pytest.mark.parametrize("shape,ranks", [((256, 256, 256), (16, 16)), ((96, 96, 96), (16, 16)),
                                         ((64, 64, 64, 64), (16, 16, 16)), ((50, 21), (7,))])
def test_multi_ttm_kernel_grid_splits_alone_see_the_batch(shape, ranks):
    plan = choose_multi_ttm_kernel_blocks(shape, ranks, 4)
    units, rtiles, s1 = multi_ttm_kernel_grid(shape, ranks, plan, H100_SMS)
    for batch in (1, 4, 16, 64):
        u, t, s = multi_ttm_kernel_grid(shape, ranks, plan, H100_SMS, batch)
        assert (u, t) == (units, rtiles) and s <= s1
    assert multi_ttm_kernel_grid(shape, ranks, plan, H100_SMS, 2 * H100_SMS)[2] == 1


@pytest.mark.parametrize("shape,strides,rank,nkeep", [
    ((1000, 1000), (64_000, 64), 64, 1),              # the 1000^3 fused node
    ((180, 180, 180), (180 * 180 * 32, 32, 180 * 32), 32, 1),
    ((256, 256), (256 * 32, 32), 32, 1),              # a 256^3 batch's node
    ((96, 96), (96 * 16, 16), 16, 1),
    ((64, 64, 64), (64 * 64 * 16, 64 * 16, 16), 16, 2),
])
def test_partial_plan_splits_alone_see_the_batch(shape, strides, rank, nkeep):
    one = choose_partial_kernel_blocks(shape, strides, rank, 4, H100_SMS, nkeep=nkeep)
    prev = one.splits
    for batch in (1, 2, 8, 16, 64):
        got = choose_partial_kernel_blocks(shape, strides, rank, 4, H100_SMS, nkeep=nkeep,
                                           batch=batch)
        assert (got.layout, got.block_rows, got.vec, got.loads) == (
            one.layout, one.block_rows, one.vec, one.loads)
        assert got.splits <= prev
        prev = got.splits
    assert choose_partial_kernel_blocks(shape, strides, rank, 4, H100_SMS, nkeep=nkeep,
                                        batch=4096).splits == 1


# -- the batch-stride width rule ----------------------------------------------------

@pytest.mark.parametrize("run,ptrs,strides,want", [
    (64, [0, 4096], [], 16),
    (64, [0], [16 * 1000], 16),         # every element's start on a 16-byte boundary
    (64, [0], [630], 0),                # bf16 (5, 7, 9) elements: 630 bytes apart
    (64, [0], [8 * 7], 8),              # 8-byte aligned starts only
    (64, [0], [4 * 3], 4),
    (64, [0, 256], [0, 4 * 64 * 5], 16),  # a shared factor (stride 0) beside a stack
    (18, [0], [16], 0),                 # the run itself is not aligned
])
def test_copy_width_sees_every_element_start(run, ptrs, strides, want):
    assert splitk.copy_width(run, ptrs, strides) == want


def test_partial_vector_width_sees_the_batch_stride():
    """The partial kernel loads 16 bytes only where every node of the batch
    starts on a 16-byte boundary (here checked on CPU tensors' pointers and
    strides, as the wrapper does on the card)."""
    rows, c, rank = 40, 30, 8
    buf = torch.zeros(3 * (rows * c * rank + 2) + 16)
    off = (-buf.data_ptr() // 4) % 4  # the first node 16-byte aligned
    base = buf[off:]
    good = base[:3 * rows * c * rank].view(3, rows, c, rank)
    bad = base.as_strided((3, rows, c, rank), (rows * c * rank + 2, c * rank, rank, 1))
    f = [torch.zeros((c, rank))]
    assert partial._kernel_view(good, f, batched=True)[-1]
    assert not partial._kernel_view(bad, f, batched=True)[-1]
    assert partial._kernel_view(bad[0], f)[-1]  # element 0 alone is aligned
    for node, vec in ((good, 4), (bad, 1)):
        ks, kst, cs, cst, _, _, _, aligned = partial._kernel_view(node, f, batched=True)
        plan = choose_partial_kernel_blocks((*ks, *cs), (*kst, *cst), rank, 4, H100_SMS,
                                            nkeep=len(ks), aligned=aligned, batch=3)
        assert plan.vec == vec


def test_the_batch_limit_is_the_grid_z_limit():
    splitk.check_batch("t", 1)
    splitk.check_batch("t", 65535)
    for bad in (0, 65536):
        with pytest.raises(ValueError, match="65535"):
            splitk.check_batch("t", bad)
