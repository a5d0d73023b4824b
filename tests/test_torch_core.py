"""The port's tensor utilities and MTTKRP references against the reference.

The same numpy inputs (made from a seed) go through ``repro`` (JAX, on the
CPU) and ``repro_torch`` (PyTorch, on the CPU). Tolerance: both sides
compute in float32 in different summation orders, so results agree to
1e-6 of the largest output magnitude (bf16 operands are widened exactly,
so the f32-accumulation paths keep the same bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.blocked as jblocked
import repro.core.krp as jkrp
from repro.core.mttkrp import mttkrp as j_mttkrp, mttkrp_naive as j_naive
import repro.core.tensor as jtensor
import repro.kernels.ref as jref
import repro_torch.core.blocked as tblocked
import repro_torch.core.krp as tkrp
import repro_torch.core.mttkrp as tmttkrp
import repro_torch.core.tensor as ttensor
import repro_torch.kernels.ref as tref

TOL = 1e-6
SHAPES = [(5, 7, 9), (12, 1, 6), (4, 5, 6, 3), (3, 4, 2, 5, 3)]


def _data(dims, rank, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(dims, dtype=np.float32)
    fs = [rng.standard_normal((d, rank), dtype=np.float32) for d in dims]
    return x, fs


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= tol * scale


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("dims", SHAPES)
def test_mttkrp_einsum_and_naive_all_modes(dims):
    x, fs = _data(dims, 5)
    for mode in range(len(dims)):
        want = j_mttkrp(jnp.asarray(x), _j(fs), mode)
        _close(tmttkrp.mttkrp(torch.from_numpy(x), _t(fs), mode), want)
        _close(tmttkrp.mttkrp_naive(torch.from_numpy(x), _t(fs), mode),
               j_naive(jnp.asarray(x), _j(fs), mode))


@pytest.mark.parametrize("block", [1, 2, 4])
@pytest.mark.parametrize("dims", SHAPES)
def test_mttkrp_blocked_all_modes(dims, block):
    x, fs = _data(dims, 4, seed=1)
    for mode in range(len(dims)):
        _close(tblocked.mttkrp_blocked(torch.from_numpy(x), _t(fs), mode, block),
               jblocked.mttkrp_blocked(jnp.asarray(x), _j(fs), mode, block))


@pytest.mark.parametrize("dims", SHAPES[:3])
def test_mttkrp_blocked_bf16_f32_acc(dims):
    """The PR-9 fix: bf16 operands with fp32 accumulation give an fp32
    result equal to the reference's."""
    x, fs = _data(dims, 3, seed=2)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ft = [f.to(torch.bfloat16) for f in _t(fs)]
    xj = jnp.asarray(x, jnp.bfloat16)
    fj = [jnp.asarray(f, jnp.bfloat16) for f in fs]
    for mode in range(len(dims)):
        got = tblocked.mttkrp_blocked(xt, ft, mode, 2, f32_acc=True)
        assert got.dtype == torch.float32
        _close(got, jblocked.mttkrp_blocked(xj, fj, mode, 2, f32_acc=True))


@pytest.mark.parametrize("dims", SHAPES)
def test_khatri_rao_and_matmul_baseline(dims):
    x, fs = _data(dims, 6, seed=3)
    _close(tkrp.khatri_rao(_t(fs)), jkrp.khatri_rao(_j(fs)))
    for mode in range(len(dims)):
        _close(tkrp.mttkrp_via_matmul(torch.from_numpy(x), _t(fs), mode),
               jkrp.mttkrp_via_matmul(jnp.asarray(x), _j(fs), mode))
        _close(ttensor.matricize(torch.from_numpy(x), mode),
               jtensor.matricize(jnp.asarray(x), mode), tol=0)


@pytest.mark.parametrize("dims", SHAPES)
def test_kernel_oracles(dims):
    x, fs = _data(dims, 4, seed=4)
    for mode in range(len(dims)):
        got = tref.mttkrp_ref(torch.from_numpy(x), _t(fs), mode)
        assert got.dtype == torch.float32
        _close(got, jref.mttkrp_ref(jnp.asarray(x), _j(fs), mode))
    if len(dims) == 3:
        _close(tref.mttkrp3_ref(torch.from_numpy(x), *_t(fs[1:])),
               jref.mttkrp3_ref(jnp.asarray(x), *_j(fs[1:])))


def test_tensor_utilities():
    x, fs = _data((4, 5, 6), 3, seed=5)
    w = np.array([0.5, 2.0, -1.0], np.float32)
    _close(ttensor.tensor_from_factors(_t(fs), torch.from_numpy(w)),
           jtensor.tensor_from_factors(_j(fs), jnp.asarray(w)))
    _close(ttensor.tensor_from_factors(_t(fs)), jtensor.tensor_from_factors(_j(fs)))
    assert abs(float(ttensor.frob_norm(torch.from_numpy(x)))
               - float(jtensor.frob_norm(jnp.asarray(x)))) <= TOL * float(np.abs(x).sum())
    assert ttensor.total_size((4, 5, 6)) == jtensor.total_size((4, 5, 6)) == 120
    g = torch.Generator().manual_seed(7)
    t, facs = ttensor.random_low_rank_tensor(g, (4, 5, 6), 3)
    assert t.shape == (4, 5, 6) and [f.shape for f in facs] == [(4, 3), (5, 3), (6, 3)]
    _close(t, ttensor.tensor_from_factors(facs), tol=0)
    g2 = torch.Generator().manual_seed(7)
    assert all(torch.equal(a, b)
               for a, b in zip(facs, ttensor.random_factors(g2, (4, 5, 6), 3)))
