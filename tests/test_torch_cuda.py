"""The Hopper kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one; whether a card
exists is decided inside the ``card`` fixture, never at import, so every
pytest worker collects the same tests. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Matmuls run in full fp32 (TF32 off). Tolerances: the kernel and the plain
version see the same inputs and both accumulate in fp32, in different
orders, so they agree to 1e-5 of the output's largest magnitude.
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.engine.plan import BlockPlan, Memory, choose_blocks
from repro_torch.kernels import ops, splitk
from repro_torch.kernels.mttkrp3 import mttkrp3, mttkrp3_plain
from repro_torch.kernels.mttkrpn import mttkrpn, mttkrpn_plain

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _data(dims, rank, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal(dims, dtype=np.float32))
    fs = [torch.as_tensor(rng.standard_normal((d, rank), dtype=np.float32)) for d in dims]
    return x.to(device, dtype), [f.to(device, dtype) for f in fs]


def _close(got, want, tol=TOL):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * max(float(want.abs().max()), 1e-30), err


SHAPES3 = [(5, 7, 9), (1, 3, 2), (33, 17, 70), (130, 9, 200), (64, 64, 64), (300, 41, 257)]
RANKS = [1, 5, 16, 33, 64]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("dims", SHAPES3)
def test_mttkrp3_matches_plain(card, dims, rank, dtype):
    x, fs = _data(dims, rank, dtype, card)
    _close(mttkrp3(x, fs[1], fs[2]), mttkrp3_plain(x, fs[1], fs[2]))


SHAPESN = [(5, 7, 9), (6, 5, 4, 7), (9, 3, 3, 10), (4, 5, 3, 2, 6), (40, 21, 19, 35)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("rank", [3, 16, 40])
@pytest.mark.parametrize("dims", SHAPESN)
def test_mttkrpn_matches_plain(card, dims, rank, dtype):
    x, fs = _data(dims, rank, dtype, card)
    _close(mttkrpn(x, fs[1:]), mttkrpn_plain(x, fs[1:]))


PLANS = [
    ((50, 40, 70), 32, BlockPlan(8, (8, 32), 32)),      # many steps and splits
    ((50, 40, 70), 40, BlockPlan(16, (8, 32), 8)),       # 5 rank tiles of 8
    ((37, 29, 61), 7, BlockPlan(3, (5, 7), 7)),          # unaligned blocks
    ((70, 33, 45), 64, BlockPlan(128, (8, 16), 64)),     # more tiles than warps
    ((20, 9, 11, 13), 12, BlockPlan(8, (4, 4, 8), 16)),
    ((300, 9, 7), 500, BlockPlan(128, (8, 8), 512)),     # 64 tiles: several passes
]


@pytest.mark.parametrize("dims,rank,plan", PLANS)
def test_pinned_plans_match_plain(card, dims, rank, plan):
    x, fs = _data(dims, rank, torch.float32, card, seed=3)
    want = mttkrpn_plain(x, fs[1:])
    _close(mttkrpn(x, fs[1:], plan=plan), want)
    if len(dims) == 3:
        _close(mttkrp3(x, fs[1], fs[2], plan=plan), want)


@pytest.mark.parametrize("variant", ["specialized", "generic"])
@pytest.mark.parametrize("dims", [(33, 17, 70), (6, 5, 4, 7)])
def test_ops_all_modes(card, dims, variant):
    x, fs = _data(dims, 6, torch.float32, card, seed=1)
    for mode in range(len(dims)):
        got = ops.mttkrp(x, fs, mode, variant=variant)
        want = repro_torch.mttkrp(x.cpu(), [f.cpu() for f in fs], mode,
                                  ctx=repro_torch.ExecutionContext.create("einsum", device="cpu"))
        _close(got.cpu(), want)


def test_kernel_is_deterministic_and_counted(card):
    x, fs = _data((300, 41, 257), 64, torch.float32, card, seed=2)
    plan = choose_blocks(x.shape, 64, memory=Memory.h100_smem())
    before = (mttkrp3.launches, splitk.splitk_reduce.launches)
    a = mttkrp3(x, fs[1], fs[2], plan=plan)
    b = mttkrp3(x, fs[1], fs[2], plan=plan)
    assert torch.equal(a, b)
    assert mttkrp3.launches == before[0] + 2
    assert splitk.splitk_reduce.launches in (before[1], before[1] + 2)


def test_splitk_reduce_matches_plain(card):
    ws = torch.randn((5, 333, 17), device=card)
    out = torch.empty((333, 17), device=card)
    _close(splitk.splitk_reduce(ws, out), splitk.splitk_reduce_plain(ws))


def test_cp_als_cuda_matches_einsum(card):
    x, fs = _data((30, 25, 20), 4, torch.float32, card, seed=5)
    init = [f.clone() for f in fs]
    ctx = repro_torch.ExecutionContext.create("cuda")
    before = mttkrp3.launches
    res = repro_torch.cp_als(x, 4, 5, init_factors=init, ctx=ctx)
    assert mttkrp3.launches == before + 15
    ref = repro_torch.cp_als(x, 4, 5, init_factors=init,
                             ctx=repro_torch.ExecutionContext.create("einsum"))
    np.testing.assert_allclose(res.fits, ref.fits, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    x, fs = _data((8, 8, 8), 4, torch.float32, card)
    with pytest.raises(ValueError):
        mttkrp3(x.transpose(0, 1), fs[1], fs[2])  # not contiguous
    with pytest.raises(ValueError):
        mttkrp3(x, fs[1].to(torch.bfloat16), fs[2])
    with pytest.raises(TypeError):
        mttkrp3(x.double(), fs[1].double(), fs[2].double())
    with pytest.raises(ValueError):  # more shared memory than a CTA has
        mttkrp3(x, fs[1], fs[2], plan=BlockPlan(512, (8, 64), 512))
