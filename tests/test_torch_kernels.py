"""The port's kernel modules on the CPU against the reference's Pallas
kernels run in interpret mode.

On a CPU tensor each kernel wrapper takes its plain version, so these tests
hold the plain versions (and the canonicalization around them) against
``repro``'s ``mttkrp3_pallas`` / ``mttkrpn_pallas`` under the same pinned
plan, carried across as the reference's plan dict. Tolerances: float32 on
both sides in different summation orders agrees to 1e-5 of the largest
output magnitude; bf16 inputs agree to 2e-2 relative (the two packages
round the bf16 results at different places).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine.plan import BlockPlan as JPlan
from repro.kernels.ops import mttkrp_canonical_pallas, mttkrp_pallas
from repro.tune.cache import plan_to_dict
from repro_torch.convert import block_plan_from_dict
from repro_torch.kernels import ops, splitk
from repro_torch.kernels.mttkrp3 import mttkrp3
from repro_torch.kernels.mttkrpn import mttkrpn

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _data(dims, rank, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(dims, dtype=np.float32)
    fs = [rng.standard_normal((d, rank), dtype=np.float32) for d in dims]
    return x, fs


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * max(float(np.abs(want).max()), 1.0)


# ragged shapes (no extent a multiple of its block) with plans pinned on both sides
PINNED = [
    ((11, 7, 9), 5, JPlan(4, (2, 4), 2)),
    ((6, 13, 10), 3, JPlan(8, (8, 8), 4)),
    ((5, 4, 3, 7), 4, JPlan(2, (3, 2, 4), 4)),
]


@pytest.mark.parametrize("dims,rank,jplan", PINNED)
def test_kernel_plain_versions_match_pallas_under_pinned_plan(dims, rank, jplan):
    x, fs = _data(dims, rank)
    plan = block_plan_from_dict(plan_to_dict(jplan))
    xt, ft = torch.from_numpy(x), [torch.from_numpy(f) for f in fs[1:]]
    xj, fj = jnp.asarray(x), [jnp.asarray(f) for f in fs[1:]]
    generic = mttkrp_canonical_pallas(xj, fj, plan=jplan, interpret=True, variant="generic")
    _close(mttkrpn(xt, ft, plan=plan), generic, F32_TOL)
    if len(dims) == 3:
        special = mttkrp_canonical_pallas(xj, fj, plan=jplan, interpret=True)
        _close(mttkrp3(xt, *ft, plan=plan), special, F32_TOL)


@pytest.mark.parametrize("dims,variant", [
    ((9, 7, 5), "specialized"), ((9, 7, 5), "generic"),
    ((4, 6, 3, 5), None), ((3, 4, 2, 3, 2), None),  # N > 3: always the generic kernel
])
def test_ops_mttkrp_matches_pallas_all_modes(dims, variant):
    x, fs = _data(dims, 4, seed=1)
    xt, ft = torch.from_numpy(x), [torch.from_numpy(f) for f in fs]
    xj, fj = jnp.asarray(x), [jnp.asarray(f) for f in fs]
    for mode in range(len(dims)):
        got = ops.mttkrp(xt, ft, mode, variant=variant)
        assert got.dtype == torch.float32
        _close(got, mttkrp_pallas(xj, fj, mode, interpret=True, variant=variant), F32_TOL)


@pytest.mark.parametrize("variant", ["specialized", "generic"])
def test_ops_mttkrp_bf16_matches_pallas(variant):
    x, fs = _data((7, 6, 5), 3, seed=2)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ft = [torch.from_numpy(f).to(torch.bfloat16) for f in fs]
    xj = jnp.asarray(x, jnp.bfloat16)
    fj = [jnp.asarray(f, jnp.bfloat16) for f in fs]
    for mode in range(3):
        got = ops.mttkrp(xt, ft, mode, variant=variant)
        assert got.dtype == torch.bfloat16  # out_dtype defaults to the input's
        _close(got, mttkrp_pallas(xj, fj, mode, interpret=True, variant=variant), BF16_TOL)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    x, fs = _data((6, 5, 4), 3, seed=3)
    xt, ft = torch.from_numpy(x), [torch.from_numpy(f) for f in fs]
    before = (mttkrp3.launches, mttkrpn.launches, splitk.splitk_reduce.launches)
    ops.mttkrp(xt, ft, 1)
    ops.mttkrp(xt, ft, 2, variant="generic")
    assert (mttkrp3.launches, mttkrpn.launches, splitk.splitk_reduce.launches) == before


def test_wrappers_refuse_other_devices_and_bad_variants():
    x = torch.zeros((2, 2, 2), device="meta")
    f = torch.zeros((2, 1), device="meta")
    with pytest.raises(ValueError):
        mttkrp3(x, f, f, plan=block_plan_from_dict(plan_to_dict(JPlan(2, (2, 2), 1))))
    with pytest.raises(ValueError):
        ops.mttkrp(torch.zeros((2, 2, 2)), [torch.zeros((2, 1))] * 3, 0, variant="fast")
    with pytest.raises(ValueError, match="einsum"):  # a matrix runs mttkrpn; one mode cannot
        ops.mttkrp(torch.zeros((2,)), [torch.zeros((2, 1))], 0)


@pytest.mark.parametrize("ctas,outer,sms,want", [
    (250, 125, 132, 2), (1000, 125, 132, 1), (1, 3, 132, 3), (8, 100, 132, 33), (10, 0, 132, 1),
])
def test_split_count_fills_the_card(ctas, outer, sms, want):
    s = splitk.n_splits(ctas, outer, sms)
    assert s == want
    assert s == 1 or s == outer or ctas * s >= splitk.CTAS_PER_SM * sms


def test_splitk_reduce_plain_on_cpu():
    ws = torch.randn((3, 5, 4), generator=torch.Generator().manual_seed(0))
    out = torch.empty((5, 4))
    assert torch.allclose(splitk.splitk_reduce(ws, out), ws.sum(0))
