"""The port's dimension tree on the CPU against the reference: all-mode
MTTKRP, the dimension-tree ALS sweep, ``cp_als(sweep="dimtree")``, and the
flop models of ``core.dimension_tree`` (exactly).

Inputs come from a numpy seed and go through both packages; tolerances
are those of ``tests/_torch_parity.py``.
"""

import itertools

import jax.numpy as jnp
import pytest
import torch

import repro
import repro.core.dimension_tree as jdt
import repro_torch
import repro_torch.core.dimension_tree as tdt
from repro.engine.tree import all_mode_mttkrp as j_all_mode
from repro.engine.tree import dimtree_als_sweep as j_dimtree_sweep
from repro_torch.convert import factors_from_numpy
from repro_torch.engine.tree import all_mode_mttkrp
from repro_torch.kernels.mttkrp3 import mttkrp3
from repro_torch.kernels.mttkrpn import mttkrpn
from repro_torch.kernels.partial import mttkrp_partial

from _torch_parity import PARAM_TOL, als_update, assert_same_cp, close, data, port_cp, problem


def _ctxs(backend):
    jref = "pallas" if backend == "cuda" else backend
    jctx = repro.ExecutionContext.create(
        backend=jref, **({"interpret": True} if jref == "pallas" else {}))
    return jctx, repro_torch.ExecutionContext.create(backend, device="cpu")


@pytest.mark.parametrize("dims", [(7, 6, 5), (5, 4, 3, 6), (3, 4, 2, 3, 2)],
                         ids=["3way", "4way", "5way"])
@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_all_mode_mttkrp_matches_reference(dims, backend):
    x, fs = data(dims, 3, seed=1)
    jctx, tctx = _ctxs(backend)
    xt, ft = torch.from_numpy(x), factors_from_numpy(fs, "cpu")
    want = j_all_mode(jnp.asarray(x), [jnp.asarray(f) for f in fs], method="dimtree", ctx=jctx)
    got = tdt.all_mode_mttkrp_dimtree(xt, ft, ctx=tctx)
    indep = all_mode_mttkrp(xt, ft, method="independent", ctx=tctx)
    for g, i, w in zip(got, indep, want):
        close(g, w)
        close(i, w)


def test_all_mode_mttkrp_rejects_unknown_method():
    ctx = repro_torch.ExecutionContext.create("einsum", device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        all_mode_mttkrp(torch.ones((2, 2, 2)), [torch.ones((2, 1))] * 3, method="tree", ctx=ctx)


@pytest.mark.parametrize("dims", [(8, 7, 6), (5, 6, 4, 5), (4, 3, 5, 2, 3)])
@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_dimtree_sweep_matches_reference(dims, backend):
    rank = 3
    x, fs = data(dims, rank, seed=2)
    jctx, tctx = _ctxs(backend)
    jf = [jnp.asarray(f) for f in fs]
    j_dimtree_sweep(jnp.asarray(x), jf, als_update(jf, rank, jnp), ctx=jctx)
    tf = factors_from_numpy(fs, "cpu")
    tdt.dimtree_als_sweep(torch.from_numpy(x), tf, als_update(tf, rank, torch), ctx=tctx)
    for a, b in zip(tf, jf):
        close(a, b, tol=PARAM_TOL)


@pytest.mark.parametrize("dims,rank,seed", [((9, 7, 8), 3, 0), ((5, 6, 4, 7), 2, 1)])
def test_cp_als_dimtree_matches_pallas_interpret(dims, rank, seed):
    x, init = problem(dims, rank, seed)
    ref = repro.cp_als(jnp.asarray(x), rank, 3, init_factors=[jnp.asarray(f) for f in init],
                       sweep="dimtree",
                       ctx=repro.ExecutionContext.create(backend="pallas", interpret=True))
    assert_same_cp(port_cp(x, init, rank, 3, "dimtree"), ref)


@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_cp_als_dimtree_is_gauss_seidel_exact(backend):
    x, init = problem((10, 9, 8, 7), 3, 2)
    assert_same_cp(port_cp(x, init, 3, 5, "dimtree", backend),
                   port_cp(x, init, 3, 5, "per_mode", backend))


def test_cpu_dimtree_launches_no_kernel():
    x, init = problem((6, 5, 4), 2, 3)
    before = (mttkrp3.launches, mttkrpn.launches, mttkrp_partial.launches)
    port_cp(x, init, 2, 1, "dimtree")
    assert (mttkrp3.launches, mttkrpn.launches, mttkrp_partial.launches) == before


FLOP_DIMS = [(5,), (7, 3), (8, 8, 8), (9, 4, 11), (3, 5, 2, 7), (12, 1, 6, 2, 3),
             (1000, 1000, 1000), (180, 180, 180, 180), (4, 3, 5, 2, 6, 2)]


@pytest.mark.parametrize("name", ["dimtree_flops", "dimtree_intermediate_words",
                                  "naive_all_mode_flops"])
def test_flop_models_match_reference_exactly(name):
    for dims, rank in itertools.product(FLOP_DIMS, [1, 3, 64]):
        assert getattr(tdt, name)(dims, rank) == getattr(jdt, name)(dims, rank), (dims, rank)
