"""The port's fused-sweep slice on the CPU against the reference: the sweep
planner, the pair and partial kernels' plain versions (against the
reference's Pallas kernels in interpret mode, under the same pinned plan),
``contract_partial`` on every edge the sweeps and trees produce, the fused
sweep, and ``cp_als(sweep="fused")``.

Inputs come from a numpy seed and go through both packages; tolerances
are those of ``tests/_torch_parity.py``.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.engine.plan as jp
import repro_torch
import repro_torch.engine.plan as tp
from repro.engine.sweep import fused_als_sweep as j_fused_sweep
from repro.kernels.ops import mttkrp_partial_canonical_pallas
from repro.kernels.sweep import fused_pair_canonical_pallas
from repro.tune.cache import plan_to_dict
from repro_torch.convert import block_plan_from_dict, factors_from_numpy
from repro_torch.engine.sweep import fused_als_sweep
from repro_torch.kernels import ops, splitk
from repro_torch.kernels.partial import mttkrp_partial
from repro_torch.kernels.sweep import fused_pair, fused_pair_canonical

from _torch_parity import PARAM_TOL, als_update, assert_same_cp, close, data, port_cp, problem


# -- the sweep planner ---------------------------------------------------------

PLAN_SHAPES = [(8, 8, 8), (5, 7, 9), (130, 6, 200), (1, 3, 2), (4, 5, 6, 3), (9, 3, 3, 10),
               (3, 4, 2, 5, 3), (1000, 1000, 1000), (180, 180, 180, 180), (4096, 16, 2048)]
PLAN_RANKS = [1, 4, 16, 64, 200]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("budget", [None, 4096, 65536, 2 ** 20])
def test_sweep_planner_matches_reference_under_tpu_vmem(budget, itemsize):
    kw = {} if budget is None else {"budget_bytes": budget}
    tmem = tp.Memory.tpu_vmem(itemsize=itemsize, **kw)
    jmem = jp.Memory.tpu_vmem(itemsize=itemsize, **kw)
    for shape, rank in itertools.product(PLAN_SHAPES, PLAN_RANKS):
        t = tp.choose_sweep_blocks(shape, rank, memory=tmem)
        j = jp.choose_sweep_blocks(shape, rank, memory=jmem)
        assert t == block_plan_from_dict(plan_to_dict(j)), (shape, rank)
        assert tp.fused_pair_working_set_words(t) == jp.fused_pair_working_set_words(j)
        assert tp.fused_pair_kernel_block_words(t) == jp.fused_pair_kernel_block_words(j)
        assert tp.choose_sweep_blocks(shape, rank, itemsize) == block_plan_from_dict(
            plan_to_dict(jp.choose_sweep_blocks(shape, rank, itemsize)))


@pytest.mark.parametrize("memory", ["tpu_vmem", "h100_smem"])
def test_rank_augmented_node_plans_match_reference(memory):
    """choose_blocks(x_has_rank=True) on the canonical node shapes the
    dimension tree and the fused sweep hand the partial kernel."""
    nodes = [(1000, 1000), (180, 180, 180), (32400, 180), (7, 5), (20, 4, 6), (3, 2, 5, 2)]
    for shape, rank, itemsize in itertools.product(nodes, PLAN_RANKS, [2, 4]):
        t = tp.choose_blocks(shape, rank, memory=getattr(tp.Memory, memory)(itemsize=itemsize),
                             x_has_rank=True)
        if memory == "tpu_vmem":
            j = jp.choose_blocks(shape, rank, memory=jp.Memory.tpu_vmem(itemsize=itemsize),
                                 x_has_rank=True)
            assert t == block_plan_from_dict(plan_to_dict(j)), (shape, rank)
            assert t.working_set_words() == j.working_set_words()
        else:
            assert t.fits(tp.Memory.h100_smem(itemsize=itemsize)), (shape, rank, t)
        assert t.x_has_rank and len(t.block_contract) == len(shape) - 1


@pytest.mark.parametrize("itemsize", [2, 4])
def test_h100_sweep_plans_fit_their_budget(itemsize):
    mem = tp.Memory.h100_smem(itemsize=itemsize)
    for shape, rank in itertools.product(PLAN_SHAPES, PLAN_RANKS):
        plan = tp.choose_sweep_blocks(shape, rank, memory=mem)
        assert tp.fused_pair_working_set_words(plan) * itemsize <= mem.budget_bytes, (
            shape, rank, plan)
        assert len(plan.block_contract) == len(shape) - 1 and not plan.x_has_rank


# -- the kernels' plain versions against the Pallas kernels ------------------

PARTIAL_PINNED = [
    ((11, 9, 5), jp.BlockPlan(4, (4,), 2, True)),
    ((6, 13, 3), jp.BlockPlan(8, (8,), 4, True)),
    ((5, 4, 3, 4), jp.BlockPlan(2, (3, 2), 4, True)),
    ((4, 3, 5, 2, 3), jp.BlockPlan(2, (2, 4, 2), 2, True)),
]


@pytest.mark.parametrize("shape,jplan", PARTIAL_PINNED)
def test_partial_plain_matches_pallas_under_pinned_plan(shape, jplan):
    rng = np.random.default_rng(1)
    node = rng.standard_normal(shape, dtype=np.float32)
    fs = [rng.standard_normal((c, shape[-1]), dtype=np.float32) for c in shape[1:-1]]
    want = mttkrp_partial_canonical_pallas(jnp.asarray(node), [jnp.asarray(f) for f in fs],
                                           plan=jplan, interpret=True)
    plan = block_plan_from_dict(plan_to_dict(jplan))
    tn, tf = torch.from_numpy(node), [torch.from_numpy(f) for f in fs]
    close(ops.mttkrp_partial_canonical(tn, tf, plan=plan), want)
    close(mttkrp_partial(tn, tf, plan=plan), want)


PAIR_PINNED = [
    ((11, 7, 9), 5, jp.BlockPlan(4, (2, 4), 2)),
    ((6, 13, 10), 3, jp.BlockPlan(8, (8, 8), 4)),
    ((5, 4, 3, 7), 4, jp.BlockPlan(2, (3, 2, 4), 4)),
]


@pytest.mark.parametrize("dims,rank,jplan", PAIR_PINNED)
def test_fused_pair_plain_matches_pallas_under_pinned_plan(dims, rank, jplan):
    x, fs = data(dims, rank, seed=2)
    jb0, jp_ = fused_pair_canonical_pallas(jnp.asarray(x), [jnp.asarray(f) for f in fs[1:]],
                                           plan=jplan, interpret=True)
    plan = block_plan_from_dict(plan_to_dict(jplan))
    b0, p = fused_pair_canonical(torch.from_numpy(x), [torch.from_numpy(f) for f in fs[1:]],
                                 plan=plan)
    assert p.shape == tuple(dims[:-1]) + (rank,)
    close(b0, jb0)
    close(p, jp_)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    x, fs = data((6, 5, 4), 3, seed=3)
    xt, ft = torch.from_numpy(x), [torch.from_numpy(f) for f in fs]
    before = (fused_pair.launches, mttkrp_partial.launches, splitk.splitk_reduce.launches)
    _, p = fused_pair(xt, ft[1:])
    mttkrp_partial(p, ft[1:2])
    assert (fused_pair.launches, mttkrp_partial.launches,
            splitk.splitk_reduce.launches) == before


def test_sweep_wrappers_refuse_what_they_do_not_take():
    with pytest.raises(ValueError):  # one contraction axis: nothing to fuse
        fused_pair(torch.zeros((3, 4)), [torch.zeros((4, 2))])
    with pytest.raises(ValueError):  # a node needs one factor per contraction axis
        mttkrp_partial(torch.zeros((3, 4, 2)), [])
    meta = torch.zeros((2, 2, 2), device="meta")
    with pytest.raises(ValueError):  # neither a CPU nor a CUDA tensor
        fused_pair(meta, [torch.zeros((2, 1), device="meta")] * 2,
                   plan=tp.BlockPlan(2, (2, 2), 1))


# -- contract_partial ------------------------------------------------------------

def _edges(n):
    """Every (modes, drop, has_rank) the dimension tree and the fused sweep
    of an n-way tensor produce."""
    out = []

    def rec(modes, has_rank):
        if len(modes) == 1:
            return
        half = max(1, len(modes) // 2)
        for child, drop in ((modes[:half], modes[half:]), (modes[half:], modes[:half])):
            out.append((modes, drop, has_rank))
            rec(child, True)

    rec(tuple(range(n)), False)
    inner = tuple(range(n - 1))
    out.append((tuple(range(n)), (n - 1,), False))
    out += [(inner, tuple(d for d in inner if d != m), True) for m in range(n - 1)]
    out.append((inner, tuple(range(1, n - 1)), True))
    return out


@pytest.mark.parametrize("dims", [(7, 6, 5), (5, 4, 3, 6)], ids=["3way", "4way"])
@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_contract_partial_matches_reference_on_every_edge(dims, backend):
    rank = 3
    x, fs = data(dims, rank, seed=4)
    rng = np.random.default_rng(5)
    jref = "pallas" if backend == "cuda" else "einsum"
    jctx = repro.ExecutionContext.create(
        backend=jref, **({"interpret": True} if jref == "pallas" else {}))
    tctx = repro_torch.ExecutionContext.create(backend, device="cpu")
    for modes, drop, has_rank in _edges(len(dims)):
        shape = tuple(dims[m] for m in modes) + ((rank,) if has_rank else ())
        node = x if len(modes) == len(dims) and not has_rank else rng.standard_normal(
            shape, dtype=np.float32)
        want = repro.contract_partial(jnp.asarray(node), [jnp.asarray(f) for f in fs], modes,
                                      drop, has_rank, ctx=jctx)
        got = repro_torch.contract_partial(torch.from_numpy(np.array(node)),
                                           factors_from_numpy(fs, "cpu"), modes, drop,
                                           has_rank, ctx=tctx)
        close(got, want)


def test_contract_partial_refuses_batches_and_bad_drops():
    """A leading batch axis was refused until the batched engine came in; it
    is now one batched call, equal to a loop. A bad ``drop`` is refused."""
    ctx = repro_torch.ExecutionContext.create("einsum", device="cpu")
    fs = [torch.ones((2, 1))] * 3
    node = torch.arange(32.0).reshape(4, 2, 2, 2)
    got = repro_torch.contract_partial(node, fs, (0, 1, 2), (2,), False, ctx=ctx)
    loop = torch.stack([repro_torch.contract_partial(node[b], fs, (0, 1, 2), (2,), False,
                                                     ctx=ctx) for b in range(4)])
    assert got.shape == (4, 2, 2, 1)
    torch.testing.assert_close(got, loop, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="subset"):
        repro_torch.contract_partial(torch.ones((2, 2, 2)), fs, (0, 1, 2), (), False, ctx=ctx)
    with pytest.raises(ValueError, match="subset"):
        repro_torch.contract_partial(node, fs, (0, 1, 2), (), False, ctx=ctx)


def test_contract_partial_under_bf16_policy_matches_reference():
    x, fs = data((6, 5, 4), 3, seed=6)
    jctx = repro.ExecutionContext.create(backend="einsum", compute_dtype="bfloat16")
    tctx = repro_torch.ExecutionContext.create("cuda", compute_dtype="bfloat16", device="cpu")
    want = repro.contract_partial(jnp.asarray(x), [jnp.asarray(f) for f in fs], (0, 1, 2),
                                  (1, 2), False, ctx=jctx)
    got = repro_torch.contract_partial(torch.from_numpy(x), factors_from_numpy(fs, "cpu"),
                                       (0, 1, 2), (1, 2), False, ctx=tctx)
    assert got.dtype == torch.float32
    close(got, want, tol=2e-2)


# -- the fused sweep and cp_als(sweep="fused") ---------------------------------

@pytest.mark.parametrize("dims", [(8, 7, 6), (5, 6, 4, 5), (4, 3, 5, 2, 3), (9, 7)])
@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_fused_sweep_matches_reference(dims, backend):
    rank = 3
    x, fs = data(dims, rank, seed=7)
    jctx = repro.ExecutionContext.create(
        backend="pallas" if backend == "cuda" else "einsum",
        **({"interpret": True} if backend == "cuda" else {}))
    jf = [jnp.asarray(f) for f in fs]
    j_fused_sweep(jnp.asarray(x), jf, als_update(jf, rank, jnp), ctx=jctx)
    tf = factors_from_numpy(fs, "cpu")
    fused_als_sweep(torch.from_numpy(x), tf, als_update(tf, rank, torch),
                    ctx=repro_torch.ExecutionContext.create(backend, device="cpu"))
    for a, b in zip(tf, jf):
        close(a, b, tol=PARAM_TOL)


@pytest.mark.parametrize("dims,rank,seed", [((9, 7, 8), 3, 0), ((5, 6, 4, 7), 2, 1)])
def test_cp_als_fused_matches_pallas_interpret(dims, rank, seed):
    x, init = problem(dims, rank, seed)
    ref = repro.cp_als(jnp.asarray(x), rank, 3, init_factors=[jnp.asarray(f) for f in init],
                       sweep="fused",
                       ctx=repro.ExecutionContext.create(backend="pallas", interpret=True))
    assert_same_cp(port_cp(x, init, rank, 3, "fused"), ref)


@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_cp_als_fused_is_gauss_seidel_exact(backend):
    x, init = problem((10, 9, 8, 7), 3, 2)
    assert_same_cp(port_cp(x, init, 3, 5, "fused", backend),
                   port_cp(x, init, 3, 5, "per_mode", backend))


def test_cp_als_default_sweep_is_per_mode():
    x, _ = problem((4, 4, 4), 2, 5)
    ctx = repro_torch.ExecutionContext.create("einsum", device="cpu")
    a = repro_torch.cp_als(torch.from_numpy(x), 2, 2, ctx=ctx)
    b = repro_torch.cp_als(torch.from_numpy(x), 2, 2, sweep="per_mode", ctx=ctx)
    assert a.fits == b.fits
