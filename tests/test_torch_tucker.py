"""The port's Tucker slice on the CPU against the reference: the Multi-TTM
planner (exact), ``multi_ttm_blocked``, ``multi_ttm`` on every kept mode and
on the full core for each backend (against the reference's einsum backend
and its Pallas kernel in interpret mode), the kernel's plain version
against ``multi_ttm_keep_pallas``, ``hosvd_init`` and ``tucker_hooi``.

Inputs come from a numpy seed and go through both packages. Tolerances:
Multi-TTM outputs agree to 1e-5 of their largest magnitude (float32 sums in
different orders), the blocked reference to 1e-6; HOOI fits within 1e-5 a
sweep, factors and core within 1e-4 after the shared sign convention. The
HOOI tensors are exact multilinear-rank tensors plus 10 % noise: that keeps
the eigen gaps wide, and keeps the fit away from 1, where both packages'
fit ``1 - sqrt(||X||^2 - ||G||^2) / ||X||`` loses its precision to fp32
cancellation (an error of about ``1e-7 / (2 (1 - fit))``).
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.engine.plan as jp
import repro_torch
import repro_torch.engine.plan as tp
from repro.core.blocked import multi_ttm_blocked as j_multi_ttm_blocked
from repro.core.tucker import hosvd_init as j_hosvd_init
from repro.core.tucker import tucker_hooi as j_tucker_hooi
from repro.kernels.multi_ttm import multi_ttm_keep_pallas
from repro.tune.cache import plan_to_dict
from repro_torch import convert
from repro_torch.core.blocked import multi_ttm_blocked
from repro_torch.core.tensor import random_tucker_tensor
from repro_torch.core.tucker import hosvd_init, ttm
from repro_torch.kernels import ops
from repro_torch.kernels.multi_ttm import multi_ttm_keep, multi_ttm_keep_plain

from _torch_parity import FIT_TOL, PARAM_TOL, close

PROBLEMS = [((12, 10, 9), (4, 3, 2)), ((8, 7, 6, 5), (3, 3, 2, 2)),
            ((17, 9, 130), (3, 4, 2)),  # extents ragged against every block
            ((24, 70), (5, 3))]  # 2-way: the kernel contracts one mode
PROBLEM_IDS = ["3way", "4way", "ragged", "2way"]
#: (problem, keep): every kept mode of each problem and the full core
CASES = [(p, keep) for p, (dims, _) in enumerate(PROBLEMS) for keep in (None, *range(len(dims)))]
CASE_IDS = [f"{PROBLEM_IDS[p]}-keep{keep}" for p, keep in CASES]


def _matrices(dims, ranks, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(dims, dtype=np.float32)
    return x, [rng.standard_normal((d, r), dtype=np.float32) for d, r in zip(dims, ranks)]


def _tucker_problem(dims, ranks, seed, noise=0.1):
    """An exact multilinear-rank tensor (orthonormal factors) plus noise."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(ranks).astype(np.float32)
    for k, (d, r) in enumerate(zip(dims, ranks)):
        q, _ = np.linalg.qr(rng.standard_normal((d, r)))
        x = np.moveaxis(np.tensordot(x, q.astype(np.float32), axes=([k], [1])), -1, k)
    x = x + noise * float(x.std()) * rng.standard_normal(dims)
    return np.ascontiguousarray(x, dtype=np.float32)


def _port_ctx(backend, **kw):
    return repro_torch.ExecutionContext.create(backend, device="cpu", **kw)


def _ref_ctx(backend, **kw):
    return repro.ExecutionContext.create(
        backend=backend, **({"interpret": True} if backend == "pallas" else {}), **kw)


# -- the planner -----------------------------------------------------------------

PLAN_SHAPES = [(8, 8, 8), (12, 10, 9), (130, 6, 200), (1, 4, 8), (8, 7, 6, 5), (9, 3, 3, 10),
               (3, 4, 2, 5, 3), (1000, 1000, 1000), (180, 180, 180, 180), (64, 48, 32)]


def _ranks_for(shape, scale):
    return tuple(max(1, min(c, scale + d)) for d, c in enumerate(shape[1:]))


@pytest.mark.parametrize("memory", ["tpu_vmem", "tpu_vmem_small", "abstract_4096",
                                    "abstract_65536", "abstract_16"])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_multi_ttm_planner_matches_reference(memory, itemsize):
    if memory.startswith("abstract"):
        words = int(memory.split("_")[1])
        tmem, jmem = tp.Memory.abstract(words, itemsize), jp.Memory.abstract(words, itemsize)
    else:
        kw = {"budget_bytes": 65536} if memory.endswith("small") else {}
        tmem = tp.Memory.tpu_vmem(itemsize=itemsize, **kw)
        jmem = jp.Memory.tpu_vmem(itemsize=itemsize, **kw)
    for shape, scale in itertools.product(PLAN_SHAPES, [1, 3, 16, 32]):
        ranks = _ranks_for(shape, scale)
        t = tp.choose_multi_ttm_blocks(shape, ranks, memory=tmem)
        j = jp.choose_multi_ttm_blocks(shape, ranks, memory=jmem)
        assert t == convert.multi_ttm_plan_from_dict(plan_to_dict(j)), (shape, ranks)
        assert t.working_set_words() == j.working_set_words()
        assert t.kernel_block_words() == j.kernel_block_words()
        assert t.weight_scratch_words() == j.weight_scratch_words()
        assert t.model_words(shape) == j.model_words(shape)
        assert t.traffic_model(shape, itemsize) == j.traffic_model(shape, itemsize)
        assert t.grid(shape) == j.grid(shape)
        assert t.padded_shape(shape) == j.padded_shape(shape)
        assert t.fits(tmem) == j.fits(jmem)
    assert tp.choose_multi_ttm_blocks((64, 48, 32), (4, 3), itemsize) == \
        convert.multi_ttm_plan_from_dict(plan_to_dict(
            jp.choose_multi_ttm_blocks((64, 48, 32), (4, 3), itemsize)))


@pytest.mark.parametrize("dims,ranks,mem", [
    ((16, 12, 10), (3, 4), 4096), ((32, 32, 32), (2, 2), 1024), ((8, 8, 8, 8), (2, 3, 2), 4096),
    ((1000, 1000, 1000), (32, 32), 2 ** 20)])
def test_uniform_multi_ttm_plan_matches_reference(dims, ranks, mem):
    t = tp.uniform_multi_ttm_plan(dims, ranks, mem)
    assert t == convert.multi_ttm_plan_from_dict(
        plan_to_dict(jp.uniform_multi_ttm_plan(dims, ranks, mem)))
    assert t == tp.uniform_multi_ttm_plan(dims, ranks, tp.Memory.abstract(mem))


@pytest.mark.parametrize("itemsize", [2, 4])
def test_kernel_plans_fit_one_cta(itemsize):
    """The wrapper's default plan (a ``MultiTTMKernelPlan``) fits by the
    kernel's own count (never the reference's Kronecker working set): the
    two-CTAs-per-SM budget unless the output tile ``prod R[:-1] x R_k``
    alone takes half of it, one CTA's limit always; one rank tile covers
    ``R_k`` up to 128, so X is read once."""
    for shape, scale in itertools.product(PLAN_SHAPES, [1, 3, 16, 32]):
        ranks = _ranks_for(shape, scale)
        plan = tp.choose_multi_ttm_kernel_blocks(shape, ranks, itemsize)
        plan.check(itemsize)
        smem = tp.multi_ttm_kernel_smem_bytes(plan, itemsize, ranks)
        assert smem <= tp.SMEM_PER_CTA_MAX
        if 4 * math.prod(ranks) <= tp.SMEM_BUDGET // 4:
            assert smem <= tp.SMEM_BUDGET, (shape, ranks, plan)
        assert isinstance(plan, tp.MultiTTMKernelPlan)
        assert plan.block_r >= min(ranks[-1], 16) and (ranks[-1] > 128 or plan.block_r >= ranks[-1])


def test_kernel_plans_at_the_main_shapes():
    assert tp.choose_multi_ttm_kernel_blocks((1000,) * 3, (32, 32)) == tp.MultiTTMKernelPlan(
        128, 32, 32, 3)
    assert tp.choose_multi_ttm_kernel_blocks((1000,) * 3, (32, 32), 2) == tp.MultiTTMKernelPlan(
        128, 64, 32, 3)
    # C_{k-1} = 180 in one 192-row tile, not two of 128 (each tile is a fold)
    assert tp.choose_multi_ttm_kernel_blocks((180,) * 4, (16,) * 3) == tp.MultiTTMKernelPlan(
        192, 32, 16, 2)
    assert tp.multi_ttm_kernel_grid((1000,) * 3, (32, 32),
                                    tp.MultiTTMKernelPlan(128, 32, 32, 2)) == (1000, 1, 1)
    assert tp.multi_ttm_kernel_grid((180,) * 4, (16,) * 3,
                                    tp.MultiTTMKernelPlan(192, 32, 16, 2)) == (180, 1, 2)
    # the reference's chooser budgets for the full Kronecker weight: tiny tiles
    h100 = tp.Memory.h100_smem()
    assert tp.choose_multi_ttm_blocks((1000,) * 3, (32, 32), memory=h100) == tp.MultiTTMPlan(
        4, (4, 4), (32, 32))
    # an output tile of 32 x 33 x 34 fp32 words leaves one CTA an SM and
    # narrow chunks
    assert tp.choose_multi_ttm_kernel_blocks((180,) * 4, (32, 33, 34)) == tp.MultiTTMKernelPlan(
        128, 8, 64, 3)
    with pytest.raises(ValueError, match="shared memory"):
        tp.choose_multi_ttm_kernel_blocks((10, 10, 10), (300, 300))


# -- the references ------------------------------------------------------------------

@pytest.mark.parametrize("keep", [None, 0, 1, 2])
@pytest.mark.parametrize("block", [1, 3, 4, 16])
def test_multi_ttm_blocked_matches_reference(keep, block):
    x, mats = _matrices((12, 10, 9), (4, 3, 2), seed=1)
    got = multi_ttm_blocked(torch.from_numpy(x), [torch.from_numpy(m) for m in mats], keep,
                            block)
    close(got, j_multi_ttm_blocked(jnp.asarray(x), [jnp.asarray(m) for m in mats], keep,
                                   block), tol=1e-6)


def test_multi_ttm_blocked_f32_acc_widens():
    x, mats = _matrices((8, 7, 6, 5), (3, 3, 2, 2), seed=2)
    xb = torch.from_numpy(x).bfloat16()
    mb = [torch.from_numpy(m).bfloat16() for m in mats]
    got = multi_ttm_blocked(xb, mb, 2, 4, f32_acc=True)
    assert got.dtype == torch.float32
    want = j_multi_ttm_blocked(jnp.asarray(x, jnp.bfloat16), [jnp.asarray(m, jnp.bfloat16)
                                                             for m in mats], 2, 4, f32_acc=True)
    close(got, want, tol=1e-6)


def test_random_tucker_tensor_is_exact_and_orthonormal():
    gen = torch.Generator().manual_seed(0)
    x, core, factors = random_tucker_tensor(gen, (10, 9, 8), (3, 2, 4))
    assert x.shape == (10, 9, 8) and core.shape == (3, 2, 4)
    for f, (d, r) in zip(factors, [(10, 3), (9, 2), (8, 4)]):
        assert f.shape == (d, r)
        torch.testing.assert_close(f.T @ f, torch.eye(r), atol=1e-5, rtol=0)
    rec = repro_torch.TuckerResult(core, factors).reconstruct()
    torch.testing.assert_close(rec, x, atol=1e-5, rtol=0)


# -- multi_ttm through the engine ----------------------------------------------------

_REF_CACHE: dict = {}


def _reference(p, keep, backend):
    """The reference's multi_ttm on problem ``p`` (cached: interpret mode is slow)."""
    key = (p, keep, backend)
    if key not in _REF_CACHE:
        dims, ranks = PROBLEMS[p]
        x, mats = _matrices(dims, ranks, seed=10 + p)
        _REF_CACHE[key] = np.asarray(repro.multi_ttm(
            jnp.asarray(x), [jnp.asarray(m) for m in mats], keep, ctx=_ref_ctx(backend)))
    return _REF_CACHE[key]


@pytest.mark.parametrize("backend", ["einsum", "blocked_host", "cuda"])
@pytest.mark.parametrize("p,keep", CASES, ids=CASE_IDS)
def test_multi_ttm_matches_reference(p, keep, backend):
    dims, ranks = PROBLEMS[p]
    x, mats = _matrices(dims, ranks, seed=10 + p)
    got = repro_torch.multi_ttm(torch.from_numpy(x), [torch.from_numpy(m) for m in mats], keep,
                                ctx=_port_ctx(backend))
    want_shape = tuple(d if k == keep else r for k, (d, r) in enumerate(zip(dims, ranks)))
    assert got.shape == want_shape and got.dtype == torch.float32
    close(got, _reference(p, keep, "einsum"))
    close(got, _reference(p, keep, "pallas"))


def test_multi_ttm_kept_matrix_may_be_none():
    x, mats = _matrices((12, 10, 9), (4, 3, 2), seed=3)
    xt, mt = torch.from_numpy(x), [torch.from_numpy(m) for m in mats]
    ctx = _port_ctx("cuda")
    torch.testing.assert_close(repro_torch.multi_ttm(xt, [mt[0], None, mt[2]], 1, ctx=ctx),
                               repro_torch.multi_ttm(xt, mt, 1, ctx=ctx))


def test_multi_ttm_validates_like_the_reference():
    x, mats = _matrices((12, 10, 9), (4, 3, 2), seed=4)
    xt, mt = torch.from_numpy(x), [torch.from_numpy(m) for m in mats]
    ctx = _port_ctx("cuda")
    with pytest.raises(ValueError, match="out of range"):
        repro_torch.multi_ttm(xt, mt, 3, ctx=ctx)
    with pytest.raises(ValueError, match="one matrix per tensor mode"):
        repro_torch.multi_ttm(xt, mt[:2], ctx=ctx)
    with pytest.raises(ValueError, match="rows"):
        repro_torch.multi_ttm(xt, [mt[0], torch.zeros(11, 3), mt[2]], None, ctx=ctx)
    with pytest.raises(ValueError, match="is None but mode 0 is contracted"):
        repro_torch.multi_ttm(xt, [None, mt[1], mt[2]], 1, ctx=ctx)
    # the reference raises the same for each
    xj, mj = jnp.asarray(x), [jnp.asarray(m) for m in mats]
    for args, match in [((xj, mj, 3), "out of range"), ((xj, mj[:2]), "one matrix per"),
                        ((xj, [None, mj[1], mj[2]], 1), "is None but mode 0")]:
        with pytest.raises(ValueError, match=match):
            repro.multi_ttm(*args)


def test_multi_ttm_cuda_rejects_a_one_way_tensor():
    """The kernel contracts the modes beside the kept one, so a vector has
    nothing for it to do; the cuda backend says so and names einsum."""
    x, a = torch.arange(6.0), torch.ones(6, 2)
    for keep in (None, 0):
        with pytest.raises(ValueError, match="at least 2 modes.*einsum"):
            repro_torch.multi_ttm(x, [a], keep, ctx=_port_ctx("cuda"))
    torch.testing.assert_close(repro_torch.multi_ttm(x, [a], None, ctx=_port_ctx("einsum")),
                               a.T @ x)


def test_batched_multi_ttm_raises_by_name():
    """A leading batch axis was refused by name until the batched engine
    came in; now the batched call equals a loop of unbatched calls (shared
    matrices), on the cuda backend too, and the reference's batched call."""
    rng = np.random.default_rng(30)
    x = rng.standard_normal((2, 4, 3, 5), dtype=np.float32)
    mats = [rng.standard_normal((d, 2), dtype=np.float32) for d in (4, 3, 5)]
    xt, mt = torch.from_numpy(x), [torch.from_numpy(m) for m in mats]
    for keep in (None, 1):
        ms = [None if k == keep else m for k, m in enumerate(mt)]
        got = repro_torch.multi_ttm(xt, ms, keep, ctx=_port_ctx("cuda"))
        loop = torch.stack([repro_torch.multi_ttm(xt[b], ms, keep, ctx=_port_ctx("cuda"))
                            for b in range(2)])
        torch.testing.assert_close(got, loop, rtol=1e-6, atol=1e-6)
        want = repro.multi_ttm(jnp.asarray(x), [None if m is None else jnp.asarray(m.numpy())
                                                for m in ms], keep)
        close(got, want)


@pytest.mark.parametrize("backend", ["einsum", "blocked_host", "cuda"])
def test_multi_ttm_bf16_policy_matches_reference(backend):
    """bf16 streams, fp32 result; the same policy as the reference's, held
    against its Pallas path (its einsum path's bf16 dot does not run on
    every CPU build of XLA)."""
    dims, ranks = (16, 12, 10), (4, 3, 2)
    x, mats = _matrices(dims, ranks, seed=5)
    xt, mt = torch.from_numpy(x), [torch.from_numpy(m) for m in mats]
    full = repro_torch.multi_ttm(xt, mt, None, ctx=_port_ctx("einsum"))
    got = repro_torch.multi_ttm(xt, mt, None, ctx=_port_ctx(backend, compute_dtype="bfloat16"))
    assert got.dtype == torch.float32
    assert float((got - full).norm() / full.norm()) < 3e-2
    want = repro.multi_ttm(jnp.asarray(x), [jnp.asarray(m) for m in mats], None,
                           ctx=_ref_ctx("pallas", compute_dtype="bfloat16"))
    assert want.dtype == jnp.float32
    close(got, want, tol=1e-2)


@pytest.mark.parametrize("keep", [0, 1])
def test_multi_ttm_pinned_plan_and_memory(keep, monkeypatch):
    """A pinned plan (carried from the reference's plan dict) reaches the
    kernel and gives the same result as the default plan; a context memory
    does not pick the plan on cuda (the reference's chooser budgets for the
    Kronecker weight the kernel never holds), so the wrapper plans."""
    x, mats = _matrices((12, 10, 9), (4, 3, 2), seed=6)
    xt, mt = torch.from_numpy(x), [torch.from_numpy(m) for m in mats]
    kernel_ranks = tuple(r for k, r in enumerate((4, 3, 2)) if k != keep)
    plan = convert.multi_ttm_plan_from_dict(plan_to_dict(jp.MultiTTMPlan(4, (5, 8), kernel_ranks)))
    seen = []
    real = ops.multi_ttm_canonical
    monkeypatch.setattr(ops, "multi_ttm_canonical",
                        lambda xp, ms, *, plan=None: seen.append(plan) or real(xp, ms, plan=plan))
    want = repro_torch.multi_ttm(xt, mt, keep, ctx=_port_ctx("einsum"))
    close(repro_torch.multi_ttm(xt, mt, keep, ctx=_port_ctx("cuda"), plan=plan), want)
    ctx = _port_ctx("cuda", memory=tp.Memory.abstract(2048, itemsize=4))
    close(repro_torch.multi_ttm(xt, mt, keep, ctx=ctx), want)
    assert seen == [plan, None]


# -- the kernel's plain version against the TPU kernel -----------------------------

PALLAS_CASES = [((16, 8, 128), (4, 3), 8, (8, 128)), ((8, 4, 6, 16), (2, 3, 2), 4, (2, 3, 8)),
                ((24, 16), (5,), 8, (8,))]


@pytest.mark.parametrize("dims,ranks,bi,bc", PALLAS_CASES)
def test_multi_ttm_keep_plain_matches_pallas(dims, ranks, bi, bc):
    x, mats = _matrices(dims, (1,) + ranks, seed=7)
    mats = mats[1:]
    want = multi_ttm_keep_pallas(jnp.asarray(x), [jnp.asarray(m) for m in mats], block_i=bi,
                                 block_contract=bc, interpret=True)
    xt, mt = torch.from_numpy(x), [torch.from_numpy(m) for m in mats]
    close(multi_ttm_keep_plain(xt, mt), want)
    plan = tp.MultiTTMPlan(bi, bc, ranks)
    close(multi_ttm_keep(xt, mt, plan=plan), want)  # a CPU tensor takes the plain version
    close(ops.multi_ttm_canonical(xt, mt, plan=plan), want)


def test_multi_ttm_keep_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="matrices"):
        multi_ttm_keep(torch.zeros(4, 3, 2), [torch.zeros(3, 2)])
    with pytest.raises(ValueError, match="matrix 1 has shape"):
        multi_ttm_keep(torch.zeros(4, 3, 2), [torch.zeros(3, 2), torch.zeros(5, 2)])


# -- HOSVD and HOOI ---------------------------------------------------------------------

TUCKER = [((12, 10, 9), (4, 3, 2), 20), ((8, 7, 6, 5), (3, 3, 2, 2), 21),
          ((13, 11, 7), (5, 2, 3), 22),
          ((30, 20), (4, 4), 25)]  # 2-way: a matrix, so R_0 = R_1
TUCKER_IDS = ["3way", "4way", "ragged", "2way"]


def _assert_same_factors(port, ref):
    for a, b in zip(port, ref):
        b = np.asarray(b)
        assert float(np.abs(a.numpy() - b).max()) <= PARAM_TOL * max(float(np.abs(b).max()), 1.0)


@pytest.mark.parametrize("dims,ranks,seed", TUCKER, ids=TUCKER_IDS)
def test_hosvd_init_matches_reference(dims, ranks, seed):
    x = _tucker_problem(dims, ranks, seed)
    port = hosvd_init(torch.from_numpy(x), ranks)
    _assert_same_factors(port, j_hosvd_init(jnp.asarray(x), ranks))
    for f, r in zip(port, ranks):
        torch.testing.assert_close(f.T @ f, torch.eye(r), atol=1e-5, rtol=0)


@pytest.mark.parametrize("backend", ["einsum", "blocked_host", "cuda"])
@pytest.mark.parametrize("dims,ranks,seed", TUCKER, ids=TUCKER_IDS)
def test_tucker_hooi_matches_reference(dims, ranks, seed, backend):
    x = _tucker_problem(dims, ranks, seed)
    ref = j_tucker_hooi(jnp.asarray(x), ranks, n_iters=4, ctx=_ref_ctx("einsum"))
    res = repro_torch.tucker_hooi(torch.from_numpy(x), ranks, n_iters=4, ctx=_port_ctx(backend))
    np.testing.assert_allclose(res.fits, ref.fits, rtol=0, atol=FIT_TOL)
    assert res.final_fit > 0.85 and res.ranks == tuple(ranks)
    _assert_same_factors(res.factors + [res.core], list(ref.factors) + [ref.core])


def test_tucker_hooi_from_reference_factors_and_convert():
    dims, ranks = (12, 10, 9), (4, 3, 2)
    x = _tucker_problem(dims, ranks, 23)
    ref = j_tucker_hooi(jnp.asarray(x), ranks, n_iters=2, ctx=_ref_ctx("pallas"))
    init = convert.factors_from_numpy([np.asarray(f) for f in ref.factors], "cpu")
    carried = convert.tucker_result_from_numpy(np.asarray(ref.core), [np.asarray(f) for f in
                                                                    ref.factors], ref.fits,
                                               device="cpu")
    assert carried.fits == [float(f) for f in ref.fits] and carried.ranks == ranks
    close(carried.reconstruct(), np.asarray(ref.reconstruct()))
    res = repro_torch.tucker_hooi(torch.from_numpy(x), ranks, n_iters=1, init_factors=init,
                                  ctx=_port_ctx("cuda"))
    again = j_tucker_hooi(jnp.asarray(x), ranks, n_iters=1, init_factors=ref.factors)
    np.testing.assert_allclose(res.fits, again.fits, rtol=0, atol=FIT_TOL)


def test_tucker_hooi_tol_and_hosvd_only_match_reference():
    dims, ranks = (10, 10, 10), (3, 3, 3)
    x = _tucker_problem(dims, ranks, 24)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    ctx = _port_ctx("cuda")
    res0 = repro_torch.tucker_hooi(xt, ranks, n_iters=0, ctx=ctx)
    ref0 = j_tucker_hooi(xj, ranks, n_iters=0)
    assert res0.core.shape == ranks and len(res0.fits) == 1
    np.testing.assert_allclose(res0.fits, ref0.fits, rtol=0, atol=FIT_TOL)
    close(res0.core, np.asarray(ref0.core), tol=PARAM_TOL)
    res = repro_torch.tucker_hooi(xt, ranks, n_iters=20, tol=1e-4, ctx=ctx)
    ref = j_tucker_hooi(xj, ranks, n_iters=20, tol=1e-4)
    assert len(res.fits) < 20 and len(res.fits) == len(ref.fits)


def test_tucker_hooi_validates_ranks_like_the_reference():
    x = torch.zeros(8, 8, 8)
    for ranks, match in [((2, 2), "one rank per tensor mode"), ((2, 9, 2), "out of range")]:
        with pytest.raises(ValueError, match=match):
            repro_torch.tucker_hooi(x, ranks, ctx=_port_ctx("einsum"))
        with pytest.raises(ValueError, match=match):
            j_tucker_hooi(jnp.zeros((8, 8, 8)), ranks)


def test_fix_signs_and_ttm_match_reference():
    from repro.core.tucker import _fix_signs as j_fix_signs
    from repro.core.tucker import ttm as j_ttm
    from repro_torch.core.tucker import _fix_signs

    v = np.array([[0.0, -3.0, 1.0], [0.0, 2.0, -1.0], [0.0, 1.0, 0.5]], dtype=np.float32)
    np.testing.assert_array_equal(_fix_signs(torch.from_numpy(v)).numpy(),
                                  np.asarray(j_fix_signs(jnp.asarray(v))))
    x, mats = _matrices((5, 4, 3), (2, 3, 2), seed=8)
    for mode, transpose in itertools.product(range(3), [True, False]):
        a = mats[mode] if transpose else mats[mode].T.copy()
        close(ttm(torch.from_numpy(x), torch.from_numpy(a), mode, transpose),
              np.asarray(j_ttm(jnp.asarray(x), jnp.asarray(a), mode, transpose)))
