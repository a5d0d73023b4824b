"""The port's equation layer and planner against the reference, exactly.

``repro_torch.core.bounds`` is a copy of ``repro.core.bounds``: every
function must return the identical value over a shape x rank x M (x grid)
lattice. ``repro_torch.engine.plan.choose_blocks`` under
``Memory.tpu_vmem()`` must return the reference's plans, with identical
Eq-10 words and traffic models; under ``Memory.h100_smem()`` every plan
must fit its budget.
"""

import inspect
import itertools

import pytest

import repro.core.bounds as jb
import repro.engine.plan as jp
import repro_torch.core.bounds as tb
import repro_torch.engine.plan as tp
from repro_torch.convert import block_plan_from_dict
from repro.tune.cache import plan_to_dict

SHAPES = [(12,), (5, 7), (8, 8, 8), (9, 4, 11), (3, 5, 2, 7), (12, 1, 6, 2, 3), (1000, 1000, 1000)]
RANKS = [1, 3, 6, 64]
MEMS = [16, 100, 4096, 2 ** 20]
GRIDS = {1: [(1,), (3,)], 2: [(1, 2), (2, 2)], 3: [(1, 2, 2), (2, 2, 2)],
         4: [(2, 1, 2, 1), (2, 2, 2, 2)], 5: [(1, 2, 1, 2, 1)]}
TUCKER_RANKS = {1: [(2,)], 2: [(2, 3)], 3: [(2, 3, 2)], 4: [(2, 2, 3, 1)], 5: [(1, 2, 2, 1, 2)]}


def _calls(name):
    """Every argument tuple of the lattice for bounds function ``name``."""
    for dims in SHAPES:
        n = len(dims)
        for rank, mem in itertools.product(RANKS, MEMS):
            procs = 1 + mem % 7
            yield {
                "seq_lb_memory": (dims, rank, mem), "seq_lb_trivial": (dims, rank, mem),
                "seq_lb": (dims, rank, mem), "par_lb_memory": (dims, rank, procs, mem),
                "par_lb_general": (dims, rank, procs, 0.5, 2.0),
                "par_lb_stationary": (dims, rank, procs, 0.5, 2.0),
                "par_lb_combined": (dims, rank, procs),
                "nr_threshold_regime": (dims, rank, procs),
                "seq_unblocked_cost": (dims, rank),
                "seq_blocked_cost": (dims, rank, 1 + mem % 9),
                "blocked_feasible_b": (n, 1 + rank % 5, mem),
                "best_block_size": (dims, mem),
                "matmul_seq_cost": (dims, rank, mem, n - 1),
                "matmul_par_cost": (dims, rank, procs),
            }.get(name, ())
            for grid in GRIDS[n]:
                yield {
                    "par_stationary_cost": (dims, rank, grid, 0),
                    "par_general_cost": (dims, rank, grid, 1 + rank % 3, 0),
                }.get(name, ())
            for ranks in TUCKER_RANKS[n]:
                yield {
                    "multi_ttm_seq_lb_memory": (dims, ranks, mem),
                    "multi_ttm_seq_lb_trivial": (dims, ranks, mem),
                    "multi_ttm_seq_lb": (dims, ranks, mem),
                    "multi_ttm_unblocked_cost": (dims, ranks),
                    "multi_ttm_blocked_cost": (dims, ranks, 1 + mem % 5),
                    "multi_ttm_blocked_feasible_b": (n, ranks, 1 + rank % 4, mem),
                    "multi_ttm_best_block_size": (dims, ranks, mem),
                    "par_multi_ttm_cost": (dims, ranks, GRIDS[n][-1]),
                }.get(name, ())


def _public_functions(mod):
    return sorted(
        n for n, f in vars(mod).items()
        if inspect.isfunction(f) and not n.startswith("_") and f.__module__ == mod.__name__
    )


BOUNDS = _public_functions(jb)


def test_bounds_has_every_reference_function():
    assert len(BOUNDS) == 24
    assert _public_functions(tb) == BOUNDS


@pytest.mark.parametrize("name", BOUNDS)
def test_bounds_function_matches_reference(name):
    calls = [args for args in _calls(name) if args]
    assert calls, name
    for args in calls:
        assert getattr(tb, name)(*args) == getattr(jb, name)(*args), (name, args)


PLAN_SHAPES = [(8, 8, 8), (5, 7, 9), (130, 6, 200), (1, 3, 2), (4, 5, 6, 3), (9, 3, 3, 10),
               (3, 4, 2, 5, 3), (1000, 1000, 1000), (180, 180, 180, 180), (4096, 16, 2048)]
PLAN_RANKS = [1, 4, 16, 64, 200]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("budget", [None, 4096, 65536, 2 ** 20])
def test_choose_blocks_matches_reference_under_tpu_vmem(budget, itemsize):
    for shape, rank in itertools.product(PLAN_SHAPES, PLAN_RANKS):
        kw = {} if budget is None else {"budget_bytes": budget}
        tmem = tp.Memory.tpu_vmem(itemsize=itemsize, **kw)
        jmem = jp.Memory.tpu_vmem(itemsize=itemsize, **kw)
        for x_has_rank in (False, True):
            t = tp.choose_blocks(shape, rank, memory=tmem, x_has_rank=x_has_rank)
            j = jp.choose_blocks(shape, rank, memory=jmem, x_has_rank=x_has_rank)
            assert t == block_plan_from_dict(plan_to_dict(j)), (shape, rank)
            assert t.eq10_words(shape, rank) == j.eq10_words(shape, rank)
            assert t.traffic_model(shape, rank, itemsize) == j.traffic_model(
                shape, rank, itemsize)
            assert t.working_set_words() == j.working_set_words()
            assert t.fits(tmem) == j.fits(jmem)
        # the default (memory=None) path is the reference's TPU default
        assert tp.choose_blocks(shape, rank, itemsize) == block_plan_from_dict(
            plan_to_dict(jp.choose_blocks(shape, rank, itemsize)))


@pytest.mark.parametrize("words", [64, 1000, 2 ** 16, 2 ** 22])
def test_uniform_planning_matches_reference(words):
    for shape, rank in itertools.product(PLAN_SHAPES, PLAN_RANKS):
        assert tp.best_uniform_block(shape, words) == jp.best_uniform_block(shape, words)
        mem = tp.Memory.abstract(words, 4)
        assert tp.best_uniform_block(shape, mem) == jp.best_uniform_block(
            shape, jp.Memory.abstract(words, 4))
        for b in (1, 2, 7):
            assert tp.uniform_block_feasible(len(shape), b, words) == \
                jp.uniform_block_feasible(len(shape), b, words)
        t, j = tp.uniform_plan(shape, rank, words), jp.uniform_plan(shape, rank, words)
        assert t == block_plan_from_dict(plan_to_dict(j))
        assert t.eq10_words(shape, rank) == tb.seq_blocked_cost(shape, rank, t.block_i)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_h100_plans_fit_their_budget(itemsize):
    mem = tp.Memory.h100_smem(itemsize=itemsize)
    assert (mem.lane, mem.sublane) == (32, 8)
    assert 2 * (mem.budget_bytes + 1024) <= tp.SMEM_PER_SM  # two CTAs per SM
    for shape, rank in itertools.product(PLAN_SHAPES, PLAN_RANKS):
        plan = tp.choose_blocks(shape, rank, memory=mem)
        assert plan.fits(mem), (shape, rank, plan)
        assert plan.working_set_words() * itemsize <= mem.budget_bytes


def test_h100_budget_is_checked():
    with pytest.raises(ValueError):
        tp.Memory.h100_smem(budget_bytes=tp.SMEM_PER_CTA_MAX + 1)
    assert tp.Memory.h100_smem(budget_bytes=tp.SMEM_PER_CTA_MAX).budget_bytes == 232_448
