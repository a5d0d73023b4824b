"""The Hopper kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one; whether a card
exists is decided inside the ``card`` fixture, never at import, so every
pytest worker collects the same tests. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Matmuls run in full fp32 (TF32 off). Tolerances: the kernel and the plain
version see the same inputs and both accumulate in fp32, in different
orders, so they agree to 1e-5 of the output's largest magnitude; an output
rounded to bf16 (the SSD kernel's, for bf16 x) within 1e-2 (a bf16 ulp is
2^-8 of the value). The Mamba2 mixer on the card against the same call on
CPU copies: 1e-4 in fp32, 5e-2 in bf16 (cuBLAS and the CPU round bf16
products at other places); the dense decoders' logits likewise, 1e-4 in
fp32. The MoE layer on the card against the CPU holds the CPU's routing
fixed on both (a router near a tie would choose other experts on another
summation order), 1e-5 in fp32.
"""

import copy
import importlib.util
import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
import repro_torch.core.tucker
from repro_torch.core.tensor import random_tucker_tensor
from repro_torch.engine.plan import (
    BlockPlan,
    Memory,
    MTTKRPKernelPlan,
    MultiTTMKernelPlan,
    MultiTTMPlan,
    PartialKernelPlan,
    choose_multi_ttm_kernel_blocks,
    choose_mttkrp_kernel_blocks,
    choose_pair_kernel_blocks,
    multi_ttm_kernel_grid,
    mttkrp_kernel_grid,
    mttkrp_kernel_smem_bytes,
    multi_ttm_kernel_smem_bytes,
    pair_kernel_grid,
    pair_kernel_smem_bytes,
    partial_kernel_smem_bytes,
    partial_kernel_threads,
)
from repro_torch.configs import get_smoke
from repro_torch.engine.sweep import fused_als_sweep
from repro_torch.engine.tree import dimtree_als_sweep
from repro_torch.kernels import multi_ttm as multi_ttm_mod
from repro_torch.kernels import ops, partial, splitk, sweep
from repro_torch.kernels.mttkrp3 import mttkrp3, mttkrp3_plain
from repro_torch.kernels.mttkrpn import mttkrpn, mttkrpn_plain
from repro_torch.kernels.multi_ttm import multi_ttm_keep, multi_ttm_keep_plain
from repro_torch.kernels.partial import mttkrp_partial, mttkrp_partial_plain
from repro_torch.kernels.ssd_intra import (
    SsdPlan,
    kernel_plan,
    kernel_smem_bytes,
    ssd_intra,
    ssd_intra_plain,
)
from repro_torch.kernels.sweep import fused_pair, fused_pair_plain
from repro_torch.models import decode_step, forward, init_decode_state, init_params
from repro_torch.models import moe
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ArchConfig

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
    ((50, 40, 70), 32, MTTKRPKernelPlan(64, 16, 32, 2)),    # two stages, many chunks and splits
    ((50, 40, 70), 40, MTTKRPKernelPlan(128, 32, 16, 4)),   # 3 rank tiles of 16
    ((37, 29, 61), 7, MTTKRPKernelPlan(64, 8, 16, 3)),      # 32-byte chunks, all ragged
    ((70, 33, 45), 64, MTTKRPKernelPlan(128, 64, 64, 2)),   # 256-byte chunks
    ((20, 9, 11, 13), 12, MTTKRPKernelPlan(64, 32, 16, 4)),
    ((300, 9, 7), 500, MTTKRPKernelPlan(128, 8, 128, 2)),   # 4 rank tiles of 128
]


@pytest.mark.parametrize("dims,rank,plan", PLANS)
def test_pinned_plans_match_plain(card, dims, rank, plan):
    x, fs = _data(dims, rank, torch.float32, card, seed=3)
    want = mttkrpn_plain(x, fs[1:])
    _close(mttkrpn(x, fs[1:], plan=plan), want)
    if len(dims) == 3:
        _close(mttkrp3(x, fs[1], fs[2], plan=plan), want)


def _misaligned(x):
    """The same values one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


# (dims, rank, dtype, plan or None, misaligned): the copy widths, the row and
# rank edges, N = 5, one contraction axis, one split and many
RAGGED = [
    ((33, 17, 7), 7, torch.float32, None, False),       # C_last * 4 = 28 bytes: 4-byte copies
    ((33, 17, 7), 7, torch.bfloat16, None, False),      # 14 bytes, R * 2 = 14: element loads
    ((33, 17, 6), 5, torch.bfloat16, None, False),      # 12 bytes: 4-byte copies
    ((70, 9, 36), 64, torch.bfloat16, None, False),     # 72 bytes: 8-byte copies
    ((100, 9, 20), 1, torch.float32, MTTKRPKernelPlan(128, 16, 16, 2), False),  # I < block_i
    ((200, 9, 20), 130, torch.float32, MTTKRPKernelPlan(128, 32, 128, 2), False),  # I > 128
    ((65, 8, 24), 64, torch.bfloat16, MTTKRPKernelPlan(64, 32, 64, 3), False),  # 2 row tiles
    ((4, 5, 3, 2, 6), 7, torch.float32, None, False),   # N = 5
    ((7, 4, 3, 2, 6), 64, torch.bfloat16, None, False),
    ((333, 41), 64, torch.float32, None, False),        # one contraction axis
    ((333, 41), 7, torch.bfloat16, None, False),
    ((40000, 7, 8), 16, torch.float32, None, False),    # 313 row tiles: one split
    ((40000, 7, 8), 16, torch.bfloat16, None, False),
    ((50, 40, 70), 32, torch.float32, MTTKRPKernelPlan(64, 16, 32, 2), True),  # 4-byte copies
    ((50, 40, 70), 32, torch.bfloat16, MTTKRPKernelPlan(64, 16, 32, 2), True),  # elements
    ((9, 3, 3, 10), 130, torch.float32, None, True),
]


@pytest.mark.parametrize("dims,rank,dtype,plan,misaligned", RAGGED)
def test_ragged_cases_match_plain(card, dims, rank, dtype, plan, misaligned):
    x, fs = _data(dims, rank, dtype, card, seed=14)
    if misaligned:
        x = _misaligned(x)
        assert x.data_ptr() % 16 != 0
    want = mttkrpn_plain(x, fs[1:])
    _close(mttkrpn(x, fs[1:], plan=plan), want)
    if len(dims) == 3:
        _close(mttkrp3(x, fs[1], fs[2], plan=plan), want)


@pytest.mark.parametrize("dims,rank,want_one",
                         [((40000, 7, 8), 16, True), ((50, 40, 70), 32, False)])
def test_split_counts_on_this_card(card, dims, rank, want_one):
    plan = choose_mttkrp_kernel_blocks(dims, rank, 4)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    splits = mttkrp_kernel_grid(dims, rank, plan, sms)[2]
    assert (splits == 1) == want_one
    before = splitk.splitk_reduce.launches
    x, fs = _data(dims, rank, torch.float32, card, seed=15)
    _close(mttkrpn(x, fs[1:]), mttkrpn_plain(x, fs[1:]))
    assert splitk.splitk_reduce.launches == before + (0 if want_one else 1)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("nc", [1, 2, 4, 7])
def test_smem_count_matches_its_mirror(card, nc, dtype):
    size = dtype.itemsize
    for bi in (64, 128):
        for width in (32, 64, 128, 256):
            for br in (16, 32, 64, 128):
                for stages in (2, 3, 4):
                    plan = MTTKRPKernelPlan(bi, width // size, br, stages)
                    assert splitk.smem_bytes(plan, dtype, nc) == mttkrp_kernel_smem_bytes(
                        plan, size, nc)
    assert splitk.smem_bytes(MTTKRPKernelPlan(96, 8, 16, 2), dtype, nc) == -1


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
    plan = choose_mttkrp_kernel_blocks(x.shape, 64, 4)
    before = (mttkrp3.launches, splitk.splitk_reduce.launches)
    a = mttkrp3(x, fs[1], fs[2], plan=plan)
    b = mttkrp3(x, fs[1], fs[2], plan=plan)
    assert torch.equal(a, b)
    assert mttkrp3.launches == before[0] + 2
    assert splitk.splitk_reduce.launches in (before[1], before[1] + 2)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("dims", [(300, 41, 257), (40, 21, 19, 35), (9000, 300)])
def test_mttkrpn_is_deterministic_and_counted(card, dims, dtype):
    x, fs = _data(dims, 33, dtype, card, seed=16)
    before = (mttkrpn.launches, mttkrp3.launches)
    runs = [mttkrpn(x, fs[1:]) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert (mttkrpn.launches, mttkrp3.launches) == (before[0] + 3, before[1])


def test_a_block_plan_on_a_cuda_tensor_is_refused(card):
    x, fs = _data((8, 8, 8), 4, torch.float32, card)
    before = (mttkrp3.launches, mttkrpn.launches)
    with pytest.raises(TypeError, match="MTTKRPKernelPlan"):
        mttkrp3(x, fs[1], fs[2], plan=BlockPlan(8, (8, 8), 16))
    with pytest.raises(TypeError, match="MTTKRPKernelPlan"):
        mttkrpn(x, fs[1:], plan=BlockPlan(8, (8, 8), 16))
    with pytest.raises(TypeError, match="MTTKRPKernelPlan"):
        repro_torch.mttkrp(x, fs, 1, ctx=repro_torch.ExecutionContext.create("cuda"),
                           plan=BlockPlan(8, (8, 8), 16))
    assert (mttkrp3.launches, mttkrpn.launches) == before


def test_splitk_reduce_matches_plain(card):
    ws = torch.randn((5, 333, 17), device=card)
    out = torch.empty((333, 17), device=card)
    _close(splitk.splitk_reduce(ws, out), splitk.splitk_reduce_plain(ws))


def _slab_sum(ws):
    """The slabs added in slab order from 0, in fp32: the kernel's bits."""
    acc = torch.zeros_like(ws[0])
    for slab in ws:
        acc += slab
    return acc


@pytest.mark.parametrize("s,i,r", [(33, 1000, 64), (1, 1000, 64), (64, 180, 32), (132, 180, 32),
                                   (7, 333, 17), (5, 333, 61), (9, 5, 3), (64, 1, 1)])
def test_splitk_reduce_is_the_slab_order_sum(card, s, i, r):
    """Bit for bit the in-order fp32 sum, and the same bits again: n a
    multiple of 4 or not (n = 20313, 5661, 15, 1); one slab, 64 and 132."""
    ws = torch.randn((s, i, r), device=card)
    out = torch.empty((i, r), device=card)
    before = splitk.splitk_reduce.launches
    got = splitk.splitk_reduce(ws, out)
    assert splitk.splitk_reduce.launches == before + 1
    assert torch.equal(got, _slab_sum(ws))
    assert torch.equal(splitk.splitk_reduce(ws, torch.empty_like(out)), got)  # repeats


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_splitk_reduce_misaligned_workspace(card, offset):
    """A workspace (and an output) that starts off a 16-byte boundary gives
    the same bits."""
    s, i, r = 12, 1000, 64
    ws = torch.randn(s * i * r + offset, device=card)[offset:].view(s, i, r)
    out = torch.empty(i * r + offset, device=card)[offset:].view(i, r)
    assert ws.data_ptr() % 16 and out.data_ptr() % 16
    assert torch.equal(splitk.splitk_reduce(ws, out), _slab_sum(ws))


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


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_cp_als_on_a_matrix_launches_mttkrpn(card, dtype):
    """A 2-way CP-ALS on ``cuda`` runs the kernel: two ``mttkrpn`` launches
    an iteration (one contraction axis each), none of the 3-way kernel."""
    x, fs = _data((300, 257), 5, torch.float32, card, seed=24)
    init = [f.clone() for f in fs]
    before = (mttkrpn.launches, mttkrp3.launches)
    res = repro_torch.cp_als(x, 5, 4, init_factors=init,
                             ctx=repro_torch.ExecutionContext.create("cuda"))
    assert (mttkrpn.launches - before[0], mttkrp3.launches - before[1]) == (8, 0)
    ref = repro_torch.cp_als(x, 5, 4, init_factors=init,
                             ctx=repro_torch.ExecutionContext.create("einsum"))
    np.testing.assert_allclose(res.fits, ref.fits, atol=1e-5)
    x, fs = x.to(dtype), [f.to(dtype) for f in fs]
    for mode in (0, 1):
        before = mttkrpn.launches
        got = ops.mttkrp(x, fs, mode, out_dtype=torch.float32)
        assert mttkrpn.launches == before + 1
        _close(got, mttkrpn_plain(*ops.canonicalize(x, fs, mode)))


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    x, fs = _data((8, 8, 8), 4, torch.float32, card)
    with pytest.raises(ValueError):
        mttkrp3(x.transpose(0, 1), fs[1], fs[2])  # not contiguous
    with pytest.raises(ValueError):
        mttkrp3(x, fs[1].to(torch.bfloat16), fs[2])
    with pytest.raises(TypeError):
        mttkrp3(x.double(), fs[1].double(), fs[2].double())
    with pytest.raises(ValueError):  # more shared memory than a CTA has
        mttkrp3(x, fs[1], fs[2], plan=MTTKRPKernelPlan(128, 64, 128, 4))
    with pytest.raises(ValueError):  # blocks the kernel does not take
        mttkrp3(x, fs[1], fs[2], plan=MTTKRPKernelPlan(96, 32, 64, 2))


# -- the fused-sweep slice: the pair kernel and the partial kernel -----------

SHAPES_PAIR = [(5, 7, 9), (1, 3, 2), (33, 17, 70), (130, 9, 200), (6, 5, 4, 7), (9, 3, 3, 10),
               (40, 21, 19, 35), (4, 5, 3, 2, 6)]


def _close_pair(got, want):
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("rank", [1, 5, 16, 33, 64])
@pytest.mark.parametrize("dims", SHAPES_PAIR)
def test_fused_pair_matches_plain(card, dims, rank, dtype):
    x, fs = _data(dims, rank, dtype, card, seed=6)
    _close_pair(fused_pair(x, fs[1:]), fused_pair_plain(x, fs[1:]))


PAIR_PLANS = [
    ((50, 40, 70), 32, MTTKRPKernelPlan(64, 16, 32, 2)),     # many tuples, chunks and splits
    ((37, 29, 61), 7, MTTKRPKernelPlan(64, 8, 16, 3)),       # 32-byte chunks, all ragged
    ((70, 33, 45), 64, MTTKRPKernelPlan(128, 64, 64, 2)),    # 256-byte chunks
    ((20, 9, 11, 13), 12, MTTKRPKernelPlan(64, 32, 16, 4)),
    ((12, 7, 5, 6, 9), 10, MTTKRPKernelPlan(64, 8, 16, 2)),
    ((300, 9, 7), 500, MTTKRPKernelPlan(128, 8, 128, 2)),    # 4 rank tiles of 128
]


@pytest.mark.parametrize("dims,rank,plan", PAIR_PLANS)
def test_fused_pair_pinned_plans_match_plain(card, dims, rank, plan):
    x, fs = _data(dims, rank, torch.float32, card, seed=7)
    _close_pair(fused_pair(x, fs[1:], plan=plan), fused_pair_plain(x, fs[1:]))


# (dims, rank, dtype, plan or None, misaligned): the copy widths, the row and
# rank edges, N = 5, one split and many
RAGGED_PAIR = [
    ((33, 17, 7), 7, torch.float32, None, False),       # C_last * 4 = 28 bytes: 4-byte copies
    ((33, 17, 7), 7, torch.bfloat16, None, False),      # 14 bytes, R * 2 = 14: element loads
    ((70, 9, 36), 64, torch.bfloat16, None, False),     # 72 bytes: 8-byte copies
    ((100, 9, 20), 1, torch.float32, None, False),      # R = 1
    ((200, 9, 20), 130, torch.float32, None, False),    # R = 130: two rank tiles
    ((65, 8, 24), 64, torch.bfloat16, MTTKRPKernelPlan(64, 32, 64, 3), False),  # 2 row tiles
    ((4, 5, 3, 2, 6), 7, torch.float32, None, False),   # N = 5
    ((40000, 7, 8), 16, torch.float32, None, False),    # 313 row tiles: one split
    ((50, 40, 70), 32, torch.float32, MTTKRPKernelPlan(64, 16, 32, 2), True),  # 4-byte copies
    ((50, 40, 70), 32, torch.bfloat16, MTTKRPKernelPlan(64, 16, 32, 2), True),  # elements
]


@pytest.mark.parametrize("dims,rank,dtype,plan,misaligned", RAGGED_PAIR)
def test_fused_pair_ragged_cases_match_plain(card, dims, rank, dtype, plan, misaligned):
    x, fs = _data(dims, rank, dtype, card, seed=21)
    if misaligned:
        x = _misaligned(x)
        assert x.data_ptr() % 16 != 0
    _close_pair(fused_pair(x, fs[1:], plan=plan), fused_pair_plain(x, fs[1:]))


@pytest.mark.parametrize("dims,rank,want_one",
                         [((40000, 7, 8), 16, True), ((50, 40, 70), 32, False)])
def test_fused_pair_split_counts_on_this_card(card, dims, rank, want_one):
    plan = choose_pair_kernel_blocks(dims, rank, 4)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert (pair_kernel_grid(dims, rank, plan, sms)[2] == 1) == want_one
    before = splitk.splitk_reduce.launches
    x, fs = _data(dims, rank, torch.float32, card, seed=22)
    _close_pair(fused_pair(x, fs[1:]), fused_pair_plain(x, fs[1:]))
    assert splitk.splitk_reduce.launches == before + (0 if want_one else 1)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("nc", [2, 4, 7])
def test_pair_smem_count_matches_its_mirror(card, nc, dtype):
    size = dtype.itemsize
    for bi in (64, 128):
        for width in (32, 64, 128, 256):
            for br in (16, 32, 64, 128):
                for stages in (2, 3, 4):
                    plan = MTTKRPKernelPlan(bi, width // size, br, stages)
                    assert sweep.smem_bytes(plan, dtype, nc) == pair_kernel_smem_bytes(
                        plan, size, nc)
    assert sweep.smem_bytes(MTTKRPKernelPlan(96, 8, 16, 2), dtype, nc) == -1


def test_a_reference_plan_on_the_ring_kernels_is_refused(card):
    x, fs = _data((8, 8, 8), 4, torch.float32, card)
    before = (fused_pair.launches, multi_ttm_keep.launches)
    with pytest.raises(TypeError, match="MTTKRPKernelPlan"):
        fused_pair(x, fs[1:], plan=BlockPlan(8, (8, 8), 16))
    with pytest.raises(TypeError, match="MultiTTMKernelPlan"):
        multi_ttm_keep(x, fs[1:], plan=MultiTTMPlan(8, (8, 8), (4, 4)))
    with pytest.raises(TypeError, match="MultiTTMKernelPlan"):
        repro_torch.multi_ttm(x, fs, 0, ctx=repro_torch.ExecutionContext.create("cuda"),
                              plan=MultiTTMPlan(8, (8, 8), (4, 4)))
    assert (fused_pair.launches, multi_ttm_keep.launches) == before


NODES = [(5, 7, 3), (1, 2, 1), (33, 70, 17), (300, 130, 64), (6, 5, 4, 7), (9, 3, 10, 16),
         (40, 21, 19, 35), (4, 5, 3, 2, 6)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", NODES)
def test_partial_matches_plain(card, shape, dtype):
    rng = np.random.default_rng(8)
    node = torch.as_tensor(rng.standard_normal(shape, dtype=np.float32)).to(card, dtype)
    fs = [torch.as_tensor(rng.standard_normal((c, shape[-1]), dtype=np.float32)).to(card, dtype)
          for c in shape[1:-1]]
    _close(mttkrp_partial(node, fs), mttkrp_partial_plain(node, fs))


# (node shape, permute, dtype, plan): both layouts, one split and many, R off
# 16 bytes (element loads), k = 3, R beyond one warp's 32 vectors (three
# rank tiles), bf16; "rows" plans read a permuted node in place
PARTIAL_PLANS = [
    ((50, 70, 32), (0, 1, 2), torch.float32, PartialKernelPlan("contract", 8, 4, 8, 5)),
    ((70, 50, 32), (1, 0, 2), torch.float32, PartialKernelPlan("rows", 64, 4, 8, 7)),
    ((37, 61, 7), (0, 1, 2), torch.float32, PartialKernelPlan("contract", 2, 1, 4, 3)),
    ((61, 37, 7), (1, 0, 2), torch.float32, PartialKernelPlan("rows", 32, 1, 4, 1)),
    ((20, 9, 11, 13), (0, 1, 2, 3), torch.float32, PartialKernelPlan("contract", 4, 1, 8, 6)),
    ((12, 7, 5, 6, 9), (0, 1, 2, 3, 4), torch.float32,
     PartialKernelPlan("contract", 4, 1, 8, 2)),
    ((7, 5, 6, 12, 9), (3, 0, 1, 2, 4), torch.float32, PartialKernelPlan("rows", 32, 1, 8, 4)),
    ((9, 40, 300), (0, 1, 2), torch.float32, PartialKernelPlan("contract", 2, 4, 8, 2)),
    ((40, 9, 300), (1, 0, 2), torch.float32, PartialKernelPlan("rows", 8, 4, 8, 2)),
    ((30, 20, 64), (0, 1, 2), torch.bfloat16, PartialKernelPlan("contract", 4, 8, 8, 3)),
    ((20, 30, 64), (1, 0, 2), torch.bfloat16, PartialKernelPlan("rows", 128, 8, 8, 3)),
]


def _node(shape, dtype, device, seed):
    rng = np.random.default_rng(seed)
    node = torch.as_tensor(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
    return node, rng


@pytest.mark.parametrize("shape,perm,dtype,plan", PARTIAL_PLANS)
def test_partial_pinned_plans_match_plain(card, shape, perm, dtype, plan):
    node, rng = _node(shape, dtype, card, 9)
    view = node.permute(perm)
    fs = [torch.as_tensor(rng.standard_normal((c, shape[-1]), dtype=np.float32)).to(card, dtype)
          for c in view.shape[1:-1]]
    _close(mttkrp_partial(view, fs, plan=plan), mttkrp_partial_plain(view.contiguous(), fs))


def _partial_edges(n):
    """Every rank-carrying (modes, drop) the dimension tree and the fused
    sweep of an n-way tensor produce."""
    out = []

    def rec(modes):
        if len(modes) == 1:
            return
        half = max(1, len(modes) // 2)
        for child, drop in ((modes[:half], modes[half:]), (modes[half:], modes[:half])):
            out.append((modes, drop))
            rec(child)

    full = tuple(range(n))
    for child in (full[:max(1, n // 2)], full[max(1, n // 2):]):
        rec(child)
    inner = tuple(range(n - 1))
    out += [(inner, tuple(d for d in inner if d != m)) for m in range(n - 1)]
    out.append((inner, tuple(range(1, n - 1))))
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("dims,rank", [((37, 29, 41), 16), ((21, 13, 17, 19), 7),
                                       ((9, 7, 11, 6, 8), 13)])
def test_partial_reads_every_contract_partial_permute_in_place(card, dims, rank, dtype):
    """Each permute ``contract_partial`` makes of a rank-carrying node (3-,
    4- and 5-way tensors) through the kernel as that strided view, against
    the plain version of its contiguous copy; then ``contract_partial``
    itself on ``cuda`` against ``einsum``."""
    rng = np.random.default_rng(14)
    fs = [torch.as_tensor(rng.standard_normal((d, rank), dtype=np.float32)).to(card, dtype)
          for d in dims]
    cuda = repro_torch.ExecutionContext.create("cuda")
    ein = repro_torch.ExecutionContext.create("einsum")
    for modes, drop in _partial_edges(len(dims)):
        shape = tuple(dims[m] for m in modes) + (rank,)
        node = torch.as_tensor(rng.standard_normal(shape, dtype=np.float32)).to(card, dtype)
        keep = tuple(m for m in modes if m not in drop)
        perm = tuple(modes.index(m) for m in keep + tuple(drop)) + (len(modes),)
        view = node.permute(perm)
        got = mttkrp_partial(view, [fs[m] for m in drop])
        _close(got, mttkrp_partial_plain(view.contiguous(), [fs[m] for m in drop]))
        if dtype == torch.float32:
            _close(repro_torch.contract_partial(node, fs, modes, drop, True, ctx=cuda),
                   repro_torch.contract_partial(node, fs, modes, drop, True, ctx=ein))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("rank", [7, 13, 32])
def test_partial_misaligned_nodes_and_odd_ranks(card, rank, dtype):
    """A node one element past a 16-byte boundary, and rows of R elements
    that are not 16-byte multiples: element loads, in both layouts."""
    node, rng = _node((45, 33, 19, rank), dtype, card, 15)
    fs = [torch.as_tensor(rng.standard_normal((c, rank), dtype=np.float32)).to(card, dtype)
          for c in (45, 33, 19)]
    for x in (node, _misaligned(node)):
        for perm in ((0, 1, 2, 3), (1, 0, 2, 3), (2, 0, 1, 3)):
            view = x.permute(perm)
            vfs = [fs[a] for a in perm[1:-1]]
            plan = partial.default_plan(view, vfs)
            wide = 16 // dtype.itemsize
            assert plan.vec == (wide if rank % wide == 0 and x.data_ptr() % 16 == 0 else 1)
            _close(mttkrp_partial(view, vfs), mttkrp_partial_plain(view.contiguous(), vfs))


def test_a_reference_plan_on_the_partial_kernel_is_refused(card):
    node, _ = _node((8, 8, 4), torch.float32, card, 16)
    fs = [torch.ones((8, 4), device=card)]
    before = mttkrp_partial.launches
    with pytest.raises(TypeError, match="PartialKernelPlan"):
        mttkrp_partial(node, fs, plan=BlockPlan(8, (8,), 4, True))
    with pytest.raises(TypeError, match="PartialKernelPlan"):
        repro_torch.contract_partial(node, [fs[0], fs[0]], (0, 1), (1,), True,
                                     ctx=repro_torch.ExecutionContext.create("cuda"),
                                     plan=BlockPlan(8, (8,), 4, True))
    with pytest.raises(ValueError):  # 16-byte loads on a misaligned node
        mttkrp_partial(_misaligned(node), fs, plan=PartialKernelPlan("contract", 8, 4, 8, 1))
    assert mttkrp_partial.launches == before


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("rank", [1, 7, 13, 32, 64, 300])
def test_partial_smem_count_matches_its_mirror(card, rank, dtype):
    size = dtype.itemsize
    for layout in ("rows", "contract"):
        for vec in (1, 16 // size):
            if rank % vec:
                continue
            tl = partial_kernel_threads(rank, vec)[1]
            for rows in (1, 2, 4, 8):
                for loads in (1, 2, 4, 8):
                    block = rows * (tl if layout == "rows" else 1)
                    plan = PartialKernelPlan(layout, block, vec, loads, 1)
                    want = partial_kernel_smem_bytes(plan, rank) if loads >= rows else -1
                    assert partial.smem_bytes(plan, dtype, rank) == want, plan
    assert partial.smem_bytes(PartialKernelPlan("contract", 3, 1, 8, 1), dtype, rank) == -1


def test_sweep_kernels_are_deterministic_and_counted(card):
    x, fs = _data((300, 41, 257), 64, torch.float32, card, seed=10)
    before = (fused_pair.launches, mttkrp_partial.launches)
    a, b = fused_pair(x, fs[1:]), fused_pair(x, fs[1:])
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    p, q = mttkrp_partial(a[1], fs[1:2]), mttkrp_partial(a[1], fs[1:2])
    assert torch.equal(p, q)
    assert (fused_pair.launches, mttkrp_partial.launches) == (before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("dims,rank", [((333, 41), 64), ((1000, 70), 17), ((9, 5), 3)])
def test_mttkrpn_with_one_contraction_axis(card, dims, rank):
    x, fs = _data(dims, rank, torch.float32, card, seed=11)
    _close(ops.mttkrp_canonical(x, fs[1:]), mttkrpn_plain(x, fs[1:]))


def test_sweep_plans_fit_one_cta(card):
    for shape in [(1000, 1000, 1000), (180, 180, 180, 180), (130, 6, 200), (9, 3, 3, 10),
                  (3, 4, 2, 5, 3), (4096, 16, 2048)]:
        for rank, dtype in [(1, torch.float32), (16, torch.float32), (64, torch.bfloat16),
                            (200, torch.float32)]:
            plan = choose_pair_kernel_blocks(shape, rank, dtype.itemsize)
            smem = sweep.smem_bytes(plan, dtype, len(shape) - 1)
            assert smem == pair_kernel_smem_bytes(plan, dtype.itemsize, len(shape) - 1)
            assert smem <= 232_448, (shape, rank, plan)
            node = torch.empty(tuple(shape[:-1]) + (rank,), device=card, dtype=dtype)
            node_fs = [torch.empty((c, rank), device=card, dtype=dtype) for c in shape[1:-1]]
            node_plan = partial.default_plan(node, node_fs)
            smem = partial.smem_bytes(node_plan, dtype, rank)
            assert smem == partial_kernel_smem_bytes(node_plan, rank) <= 232_448, (
                shape, rank, node_plan)


def _update(factors, rank):
    grams = [f.T @ f for f in factors]

    def update(mode, b):
        gamma = torch.ones((rank, rank), device=b.device)
        for k, g in enumerate(grams):
            if k != mode:
                gamma = gamma * g
        a = torch.linalg.solve(gamma + 1e-3 * torch.eye(rank, device=b.device), b.T).T
        grams[mode] = a.T @ a
        return a

    return update


@pytest.mark.parametrize("dims,counts", [
    ((30, 25, 20), {"fused": (1, 1, 1, 0), "dimtree": (0, 2, 1, 1)}),
    ((12, 10, 9, 11), {"fused": (1, 2, 0, 1), "dimtree": (0, 4, 2, 0)}),
])
def test_sweep_launch_counts_and_gauss_seidel(card, dims, counts):
    """(fused_pair, mttkrp_partial, mttkrp3, mttkrpn) launches in one sweep,
    and each schedule's factors equal the per-mode sweep's."""
    x, fs = _data(dims, 4, torch.float32, card, seed=12)
    ctx = repro_torch.ExecutionContext.create("cuda")
    ref = [f.clone() for f in fs]
    upd = _update(ref, 4)
    for mode in range(len(dims)):
        ref[mode] = upd(mode, repro_torch.mttkrp(x, ref, mode, ctx=ctx))
    kernels = (fused_pair, mttkrp_partial, mttkrp3, mttkrpn)
    for name, run in (("fused", fused_als_sweep), ("dimtree", dimtree_als_sweep)):
        got = [f.clone() for f in fs]
        before = [k.launches for k in kernels]
        run(x, got, _update(got, 4), ctx=ctx)
        assert tuple(k.launches - b for k, b in zip(kernels, before)) == counts[name]
        for g, r in zip(got, ref):
            _close(g, r, tol=1e-4)


# -- the Tucker slice: the kept-mode Multi-TTM kernel ------------------------------

SHAPES_TTM = [((5, 7, 9), (2, 3)), ((1, 3, 2), (1, 2)), ((33, 17, 70), (4, 5)),
              ((130, 9, 200), (8, 3)), ((6, 5, 4, 7), (2, 3, 2)), ((9, 3, 3, 10), (3, 1, 4)),
              ((40, 21, 19, 35), (5, 4, 6)), ((4, 5, 3, 2, 6), (2, 2, 1, 3)), ((300, 70), (9,)),
              ((17, 200), (33,))]


def _ttm_data(dims, ranks, dtype, device, seed):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal(dims, dtype=np.float32))
    mats = [torch.as_tensor(rng.standard_normal((d, r), dtype=np.float32))
            for d, r in zip(dims[1:], ranks)]
    return x.to(device, dtype), [m.to(device, dtype) for m in mats]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("dims,ranks", SHAPES_TTM)
def test_multi_ttm_keep_matches_plain(card, dims, ranks, dtype):
    x, mats = _ttm_data(dims, ranks, dtype, card, seed=13)
    _close(multi_ttm_keep(x, mats), multi_ttm_keep_plain(x, mats))


TTM_PLANS = [
    ((50, 40, 70), (4, 6), MultiTTMKernelPlan(64, 16, 16, 2)),       # tiles along c_1, splits
    ((37, 29, 61), (3, 2), MultiTTMKernelPlan(64, 8, 16, 3)),        # 32-byte chunks, ragged
    ((70, 33, 45), (5, 40), MultiTTMKernelPlan(128, 64, 64, 2)),     # R_k = 40 of 64 columns
    ((20, 9, 11, 13), (2, 3, 4), MultiTTMKernelPlan(64, 32, 16, 4)),  # outer weights
    ((12, 7, 5, 6, 9), (2, 2, 3, 2), MultiTTMKernelPlan(64, 8, 16, 2)),
    ((60, 9, 300), (3, 130), MultiTTMKernelPlan(128, 32, 128, 2)),   # two rank tiles
    ((40, 500), (7,), MultiTTMKernelPlan(64, 32, 16, 3)),            # k = 1: rows are i
    ((1000, 12, 12), (12, 12), MultiTTMKernelPlan(64, 8, 16, 2)),    # many i, one tile each
    ((30, 6, 180, 40), (3, 5, 7), MultiTTMKernelPlan(192, 16, 16, 2)),  # 192-row tiles
    ((20, 400, 36), (9, 33), MultiTTMKernelPlan(192, 32, 64, 2)),     # 3 tiles of 192, ragged
]


@pytest.mark.parametrize("dims,ranks,plan", TTM_PLANS)
def test_multi_ttm_keep_pinned_plans_match_plain(card, dims, ranks, plan):
    x, mats = _ttm_data(dims, ranks, torch.float32, card, seed=14)
    _close(multi_ttm_keep(x, mats, plan=plan), multi_ttm_keep_plain(x, mats))


# (dims, ranks, dtype, misaligned): unaligned rows, a misaligned pointer, R_k
# of 1, 7 and 130, one split and many
RAGGED_TTM = [
    ((33, 17, 7), (3, 7), torch.float32, False),        # 28-byte rows: 4-byte copies
    ((33, 17, 7), (3, 7), torch.bfloat16, False),       # 14-byte rows: element loads
    ((70, 9, 36), (4, 1), torch.bfloat16, False),       # R_k = 1
    ((30, 200, 20), (5, 130), torch.float32, False),    # R_k = 130: two rank tiles
    ((2000, 8, 24), (3, 5), torch.float32, False),      # 2000 i: one split
    ((20, 300, 64), (6, 8), torch.float32, False),      # 3 tiles an i: splits
    ((50, 40, 70), (4, 6), torch.float32, True),
    ((50, 40, 70), (4, 6), torch.bfloat16, True),
    ((9, 5, 7, 11, 13), (2, 3, 2, 4), torch.bfloat16, True),
]


@pytest.mark.parametrize("dims,ranks,dtype,misaligned", RAGGED_TTM)
def test_multi_ttm_keep_ragged_cases_match_plain(card, dims, ranks, dtype, misaligned):
    x, mats = _ttm_data(dims, ranks, dtype, card, seed=23)
    if misaligned:
        x = _misaligned(x)
        assert x.data_ptr() % 16 != 0
    _close(multi_ttm_keep(x, mats), multi_ttm_keep_plain(x, mats))


def test_multi_ttm_keep_is_deterministic_and_counted(card):
    x, mats = _ttm_data((60, 200, 257), (16, 16), torch.float32, card, seed=15)
    plan = choose_multi_ttm_kernel_blocks(x.shape, (16, 16), 4)
    assert multi_ttm_kernel_grid(x.shape, (16, 16), plan)[2] == 2  # 60 i, two tiles each
    before = (multi_ttm_keep.launches, splitk.splitk_reduce.launches)
    a, b = multi_ttm_keep(x, mats), multi_ttm_keep(x, mats)
    assert torch.equal(a, b)
    assert multi_ttm_keep.launches == before[0] + 2
    assert splitk.splitk_reduce.launches == before[1] + 2


def test_multi_ttm_plans_fit_one_cta(card):
    """The wrapper's plans fit one CTA by the library's own count, which the
    planner's host-side mirror reproduces exactly."""
    for shape, ranks in [((1000, 1000, 1000), (32, 32)), ((180, 180, 180, 180), (16, 16, 16)),
                         ((130, 6, 200), (5, 4)), ((9, 3, 3, 10), (3, 3, 3)),
                         ((3, 4, 2, 5, 3), (2, 2, 2, 2)), ((180, 180, 180, 180), (32, 33, 34)),
                         ((300, 70), (9,))]:
        for dtype in (torch.float32, torch.bfloat16):
            plan = choose_multi_ttm_kernel_blocks(shape, ranks, dtype.itemsize)
            smem = multi_ttm_mod.smem_bytes(plan, dtype, ranks)
            assert smem == multi_ttm_kernel_smem_bytes(plan, dtype.itemsize, ranks), (shape, plan)
            assert smem <= 232_448, (shape, ranks, plan)
            pinned = MultiTTMKernelPlan(64, 64 // dtype.itemsize, 32, 3)
            assert multi_ttm_mod.smem_bytes(pinned, dtype, ranks) == multi_ttm_kernel_smem_bytes(
                pinned, dtype.itemsize, ranks)
    assert multi_ttm_mod.smem_bytes(MultiTTMKernelPlan(96, 8, 16, 2), torch.float32, (2, 3)) == -1


def test_multi_ttm_keep_rejects_what_the_kernel_does_not_take(card):
    x, mats = _ttm_data((8, 8, 8), (2, 3), torch.float32, card, seed=16)
    with pytest.raises(ValueError, match="contiguous"):
        multi_ttm_keep(x.transpose(0, 1), mats)
    with pytest.raises(ValueError, match="matrix 0"):
        multi_ttm_keep(x, [mats[0].to(torch.bfloat16), mats[1]])
    with pytest.raises(ValueError, match="matrix 1"):
        multi_ttm_keep(x, [mats[0], mats[1].T.contiguous().T])
    with pytest.raises(ValueError, match="matrix 1 has shape"):
        multi_ttm_keep(x, [mats[0], mats[1][:5]])
    with pytest.raises(TypeError, match="MultiTTMKernelPlan"):
        multi_ttm_keep(x, mats, plan=MultiTTMPlan(8, (8, 8), (2, 4)))
    with pytest.raises(TypeError):
        multi_ttm_keep(x.double(), [m.double() for m in mats])
    with pytest.raises(ValueError, match="shared memory"):
        multi_ttm_keep(x, mats, plan=MultiTTMKernelPlan(128, 64, 128, 4))
    with pytest.raises(ValueError, match="takes block_m"):
        multi_ttm_keep(x, mats, plan=MultiTTMKernelPlan(96, 32, 16, 2))


def test_multi_ttm_engine_all_keeps(card):
    x, mats = _ttm_data((1, 33, 17, 70), (3, 4, 5), torch.float32, card, seed=17)
    x = x[0]
    ctx = repro_torch.ExecutionContext.create("cuda")
    ein = repro_torch.ExecutionContext.create("einsum")
    for keep in (None, 0, 1, 2):
        before = multi_ttm_keep.launches
        got = repro_torch.multi_ttm(x, mats, keep, ctx=ctx)
        assert multi_ttm_keep.launches == before + 1
        _close(got, repro_torch.multi_ttm(x, mats, keep, ctx=ein))


@pytest.mark.parametrize("keep", [None, 0, 1])
@pytest.mark.parametrize("dims,ranks", [((300, 70), (9, 7)), ((17, 200), (5, 33)),
                                        ((40, 500), (6, 7))])
def test_multi_ttm_engine_two_way(card, dims, ranks, keep):
    """A matrix goes through the kernel too (one contracted mode, split
    along c_k); keep=None adds the small A_0^T Z."""
    rng = np.random.default_rng(19)
    x = torch.as_tensor(rng.standard_normal(dims, dtype=np.float32)).to(card)
    mats = [torch.as_tensor(rng.standard_normal((d, r), dtype=np.float32)).to(card)
            for d, r in zip(dims, ranks)]
    before = multi_ttm_keep.launches
    got = repro_torch.multi_ttm(x, mats, keep, ctx=repro_torch.ExecutionContext.create("cuda"))
    assert multi_ttm_keep.launches == before + 1
    _close(got, repro_torch.multi_ttm(x, mats, keep,
                                      ctx=repro_torch.ExecutionContext.create("einsum")))


def test_multi_ttm_context_memory_leaves_the_kernel_plan(card):
    """``ctx.memory`` does not plan the Multi-TTM kernel: the result is the
    wrapper's default plan's, bit for bit."""
    x, mats = _ttm_data((1, 60, 45, 70), (4, 5, 6), torch.float32, card, seed=20)
    x = x[0]
    plain = repro_torch.ExecutionContext.create("cuda")
    budget = repro_torch.ExecutionContext.create("cuda", memory=Memory.h100_smem())
    for keep in (None, 0, 2):
        assert torch.equal(repro_torch.multi_ttm(x, mats, keep, ctx=budget),
                           repro_torch.multi_ttm(x, mats, keep, ctx=plain))


def test_tucker_hooi_cuda_matches_einsum(card):
    gen = torch.Generator(device=card).manual_seed(18)
    x, _, _ = random_tucker_tensor(gen, (40, 35, 30), (5, 4, 3))
    x += 0.1 * float(x.std()) * torch.randn(x.shape, generator=gen, device=card)
    init = repro_torch.core.tucker.hosvd_init(x, (5, 4, 3))
    ctx = repro_torch.ExecutionContext.create("cuda")
    before = multi_ttm_keep.launches
    res = repro_torch.tucker_hooi(x, (5, 4, 3), 4, init_factors=init, ctx=ctx)
    assert multi_ttm_keep.launches == before + 12
    ref = repro_torch.tucker_hooi(x, (5, 4, 3), 4, init_factors=init,
                                  ctx=repro_torch.ExecutionContext.create("einsum"))
    np.testing.assert_allclose(res.fits, ref.fits, rtol=0, atol=1e-5)
    for a, b in zip(res.factors, ref.factors):
        _close(a, b, tol=1e-4)
    before = multi_ttm_keep.launches
    repro_torch.tucker_hooi(x, (5, 4, 3), 0, init_factors=init, ctx=ctx)
    assert multi_ttm_keep.launches == before + 1


# --------------------------------------------------------------------------
# the intra-chunk SSD kernel and the Mamba2 path
# --------------------------------------------------------------------------

SSD_MIX = {  # x's dtype, the small operands' dtype
    "x_bf16": (torch.bfloat16, torch.float32),
    "f32": (torch.float32, torch.float32),
    "bf16": (torch.bfloat16, torch.bfloat16),
}


def _ssd_data(bcn, q, n, h, p, mix, device, seed=0):
    rng = np.random.default_rng(seed)
    xt, st = SSD_MIX[mix]
    cc = torch.as_tensor(rng.standard_normal((bcn, q, n), dtype=np.float32))
    bc = torch.as_tensor(rng.standard_normal((bcn, q, n), dtype=np.float32))
    steps = np.log1p(np.exp(rng.standard_normal((bcn, q, h)))).astype(np.float32)
    cum = torch.as_tensor(-np.cumsum(steps, axis=1, dtype=np.float32))
    dt = torch.as_tensor(np.log1p(np.exp(rng.standard_normal((bcn, q, h)))).astype(np.float32))
    x = torch.as_tensor(rng.standard_normal((bcn, q, h, p), dtype=np.float32))
    return [t.to(device, st) for t in (cc, bc, cum, dt)] + [x.to(device, xt)]


def _ssd_close(got, want):
    _close(got, want, tol=1e-2 if want.dtype == torch.bfloat16 else TOL)


@pytest.mark.parametrize("mix", list(SSD_MIX))
@pytest.mark.parametrize("h,hb", [(4, 2), (8, 4), (80, 8)])
@pytest.mark.parametrize("q", [8, 16, 64, 200, 256])
def test_ssd_intra_matches_plain(card, q, h, hb, mix):
    args = _ssd_data(2, q, 32, h, 64, mix, card, seed=q + h)
    got = ssd_intra(*args, head_block=hb)
    assert got.dtype == args[4].dtype
    _ssd_close(got, ssd_intra_plain(*args))


@pytest.mark.parametrize("bcn,q,n,h,p", [(3, 37, 20, 6, 6), (1, 129, 128, 3, 24),
                                         (5, 65, 7, 2, 130), (2, 256, 128, 80, 64)])
def test_ssd_intra_ragged_shapes(card, bcn, q, n, h, p):
    """q, N and P off every tile (P=130: 16-row tiles), and the served shape."""
    args = _ssd_data(bcn, q, n, h, p, "f32", card, seed=q)
    _ssd_close(ssd_intra(*args, head_block=1), ssd_intra_plain(*args))


@pytest.mark.parametrize("plan", [SsdPlan(16, 1), SsdPlan(32, 2), SsdPlan(64, 3), SsdPlan(64, 6)])
def test_ssd_intra_pinned_plans_match_plain(card, plan):
    args = _ssd_data(2, 100, 48, 6, 32, "x_bf16", card, seed=3)
    _ssd_close(ssd_intra(*args, plan=plan), ssd_intra_plain(*args))


def test_ssd_intra_is_deterministic_and_counted(card):
    args = _ssd_data(4, 256, 128, 16, 64, "x_bf16", card, seed=4)
    before = ssd_intra.launches
    a, b = ssd_intra(*args), ssd_intra(*args)
    assert ssd_intra.launches == before + 2
    assert torch.equal(a, b)


def test_ssd_intra_no_nan_above_the_diagonal(card):
    """Steep decay: exp(cum_i - cum_j) overflows for j > i; the kernel
    selects j <= i before the exp."""
    cc, bc, cum, dt, x = _ssd_data(2, 64, 16, 4, 16, "f32", card, seed=5)
    cum = cum * 40.0
    got = ssd_intra(cc, bc, cum, dt, x)
    assert bool(torch.isfinite(got).all())
    _ssd_close(got, ssd_intra_plain(cc, bc, cum, dt, x))


def test_ssd_intra_shared_memory_count(card):
    from repro_torch.kernels import ssd_intra as ssd_mod

    for q in (8, 100, 256, 1000):
        for p in (6, 64, 128, 130, 256):
            for tile in (16, 32, 64):
                for itemsize in (2, 4):
                    want = (kernel_smem_bytes(q, p, tile, itemsize)
                            if ssd_mod.valid_tile(p, tile) else -1)
                    assert ssd_mod.smem_bytes(q, p, tile, itemsize) == want
    props = torch.cuda.get_device_properties(card)
    per_sm = getattr(props, "shared_memory_per_multiprocessor", 233472)
    for itemsize in (2, 4):  # two CTAs an SM at the served shape
        plan = kernel_plan(256, 80, 64, itemsize, bcn=64)
        assert 2 * ssd_mod.smem_bytes(256, 64, plan.tile, itemsize) <= per_sm


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(2, 256, 32, 8, 64), (3, 100, 48, 6, 40)])
def test_ssd_intra_keeps_the_lo_product(card, shape):
    """The bf16 mix keeps fp32 weights (hi + lo bf16 products): on operands
    where weights rounded to bf16 once show in the bf16 output
    (``chip_smoke.ssd_cancelling``), the kernel reads within ``LO_TOL`` of
    the fp32 sums and that control above it."""
    cs = _chip_smoke()
    args = cs.ssd_cancelling(torch.Generator(device="cuda").manual_seed(sum(shape)), *shape)
    reading, control = cs.ssd_lo_readings(args, ssd_intra(*args))
    assert reading <= cs.LO_TOL < control


@pytest.mark.parametrize("mix", list(SSD_MIX))
def test_ssd_intra_misaligned_pointers(card, mix):
    """X (and C, B) starting off a 16-byte boundary: 4-byte copies for fp32
    X, element loads for bf16 X (2 bytes off), 4-byte copies for C and B."""
    args = _ssd_data(2, 100, 48, 6, 64, mix, card, seed=8)
    moved = []
    for t in args:
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        moved.append(view)
    assert all(t.data_ptr() % 16 for t in moved)
    want = ssd_intra_plain(*args)
    got = ssd_intra(*moved)
    _ssd_close(got, want)
    assert torch.equal(got, ssd_intra(*args))  # the same bits as from aligned operands


@pytest.mark.parametrize("mix", list(SSD_MIX))
@pytest.mark.parametrize("p", [13, 60, 100])
def test_ssd_intra_p_off_eight(card, p, mix):
    """P not a multiple of 8: odd (element loads for bf16, 4-byte copies for
    fp32), 60 (8-byte copies for bf16), 100 (two column blocks of warps)."""
    args = _ssd_data(3, 80, 32, 4, p, mix, card, seed=p)
    _ssd_close(ssd_intra(*args), ssd_intra_plain(*args))


def _mamba_cfg(dtype):
    """A narrow Mamba2 (d_model 128, 4 heads of 64, state 32, chunk 64)."""
    return ArchConfig(name="mamba2-test", family="ssm", n_layers=3, d_model=128, n_heads=0,
                      n_kv_heads=0, d_ff=0, vocab_size=300, ssm_state=32, ssm_head_dim=64,
                      ssm_chunk=64, tie_embeddings=True, dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_ssm_on_the_card_matches_cpu(card, dtype):
    cfg = _mamba_cfg(dtype)
    gen = torch.Generator().manual_seed(6)
    p = ssm_mod.init_ssm(gen, cfg, getattr(torch, dtype), "cpu")
    x = torch.randn((2, 192, cfg.d_model), generator=gen).to(getattr(torch, dtype))
    want = ssm_mod.apply_ssm(p, x, cfg)
    before = ssd_intra.launches
    got = ssm_mod.apply_ssm(p.to(card), x.to(card), cfg)
    assert ssd_intra.launches == before + 1
    _close(got.cpu(), want, tol=1e-4 if dtype == "float32" else 5e-2)


def test_forward_launches_once_a_layer_and_decode_never(card):
    cfg = _mamba_cfg("bfloat16")
    model = init_params(cfg, generator=torch.Generator(device=card).manual_seed(7))
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), device=card)
    before = ssd_intra.launches
    lg, _ = forward(model, cfg, {"tokens": tokens}, mode="prefill", logits_positions="last")
    assert ssd_intra.launches == before + cfg.n_layers
    assert lg.shape == (2, 1, cfg.padded_vocab) and bool(torch.isfinite(lg).all())
    state = init_decode_state(model, cfg, 2, 16)
    for t in range(3):
        lg, state = decode_step(model, cfg, state, tokens[:, t:t + 1])
    assert ssd_intra.launches == before + cfg.n_layers


def _launch_counts() -> tuple:
    return (mttkrp3.launches, mttkrpn.launches, splitk.splitk_reduce.launches,
            fused_pair.launches, mttkrp_partial.launches, multi_ttm_keep.launches,
            ssd_intra.launches)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "deepseek-coder-33b", "yi-34b",
                                  "nemotron-4-340b"])
def test_dense_decoder_on_the_card_matches_cpu(card, name):
    """A smoke-sized dense decoder (GQA, RoPE, the MLP; qwen2's QKV biases
    made random) in fp32 on the card against the same weights on the CPU:
    forward in both modes and 8 decode steps within 1e-4, no kernel launched."""
    cfg = replace(get_smoke(name), dtype="float32")
    gen = torch.Generator().manual_seed(8)
    model = init_params(cfg, generator=gen, device="cpu")
    for layer in model.blocks:
        for b in ("bq", "bk", "bv"):
            if b in layer.attn:
                getattr(layer.attn, b).copy_(torch.randn(getattr(layer.attn, b).shape,
                                                         generator=gen))
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    on_card = copy.deepcopy(model).to(card)
    v = cfg.vocab_size
    before = _launch_counts()
    for mode in ("train", "prefill"):
        want, _ = forward(model, cfg, {"tokens": tokens}, mode=mode)
        got, _ = forward(on_card, cfg, {"tokens": tokens.to(card)}, mode=mode)
        _close(got[..., :v].cpu(), want[..., :v], tol=1e-4)
    state = init_decode_state(model, cfg, 2, 8)
    card_state = init_decode_state(on_card, cfg, 2, 8)
    assert card_state["caches"][0].k.device.type == card.type
    for t in range(8):
        want, state = decode_step(model, cfg, state, tokens[:, t:t + 1])
        got, card_state = decode_step(on_card, cfg, card_state, tokens[:, t:t + 1].to(card))
        _close(got[..., :v].cpu(), want[..., :v], tol=1e-4)
    assert _launch_counts() == before


@pytest.mark.parametrize("name", ["qwen2-vl-72b", "whisper-tiny"])
def test_frontend_models_on_the_card_match_cpu(card, name):
    """The smoke-sized VLM backbone and encoder-decoder model in fp32 on the
    card against the same weights on the CPU: forward from embeds in both
    modes, then 8 decode steps (whisper's with the forward's encoder states
    as ``cross_kv``) within 1e-4, no kernel launched."""
    from repro_torch.models.model import _encoder_kv
    from repro_torch.models.blocks import apply_stack
    from repro_torch.models.layers import apply_norm

    cfg = replace(get_smoke(name), dtype="float32")
    gen = torch.Generator().manual_seed(9)
    model = init_params(cfg, generator=gen, device="cpu")
    embeds = torch.randn((2, 32, cfg.d_model), generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    batch = {"embeds": embeds, **({"dec_tokens": tokens} if cfg.is_encdec else {})}
    on_card = copy.deepcopy(model).to(card)
    v = cfg.vocab_size
    before = _launch_counts()
    for mode in ("train", "prefill"):
        want, _ = forward(model, cfg, batch, mode=mode)
        got, _ = forward(on_card, cfg, {k: t.to(card) for k, t in batch.items()}, mode=mode)
        _close(got[..., :v].cpu(), want[..., :v], tol=1e-4)
    kv = card_kv = None
    if cfg.is_encdec:
        pos = torch.arange(32).expand(2, 32)
        with torch.no_grad():
            enc, _ = apply_stack(model.encoder, embeds, cfg, pos, causal=False)
            kv = _encoder_kv(cfg, apply_norm(model.enc_norm, enc))
        card_kv = tuple(t.to(card) for t in kv)
    state = init_decode_state(model, cfg, 2, 8)
    card_state = init_decode_state(on_card, cfg, 2, 8)
    for t in range(8):
        want, state = decode_step(model, cfg, state, tokens[:, t:t + 1], cross_kv=kv)
        got, card_state = decode_step(on_card, cfg, card_state, tokens[:, t:t + 1].to(card),
                                      cross_kv=card_kv)
        _close(got[..., :v].cpu(), want[..., :v], tol=1e-4)
    assert _launch_counts() == before


# -- batched calls: one launch for B problems, the batch the grid's z axis ----

def _batch_data(batch, dims, rank, dtype, device, shared=False, seed=0):
    """A ``(B, *dims)`` tensor and per-element ``(B, I_k, R)`` factors (or
    shared ``(I_k, R)`` ones)."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((batch, *dims), dtype=np.float32))
    lead = () if shared else (batch,)
    fs = [torch.as_tensor(rng.standard_normal((*lead, d, rank), dtype=np.float32))
          for d in dims]
    return x.to(device, dtype), [f.to(device, dtype) for f in fs]


def _elem(f, b):
    return f[b] if f.ndim == 3 else f


BATCH_CASES = [  # (B, dims, R); (5, 7, 9) has an odd product: bf16 elements start misaligned
    (3, (5, 7, 9), 5), (1, (33, 17, 70), 16), (4, (64, 64, 64), 33), (2, (6, 5, 4, 7), 7),
    (5, (40, 21, 19, 35), 16), (7, (300, 41, 9), 13),
]


@pytest.mark.parametrize("shared", [False, True], ids=["per_element", "shared"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("batch,dims,rank", BATCH_CASES)
def test_batched_mttkrp_kernel_is_one_launch(card, batch, dims, rank, dtype, shared):
    """mttkrp3 / mttkrpn on a batch: one launch (and at most one split-K
    reduction), equal to the plain version and to a loop of B launches."""
    x, fs = _batch_data(batch, dims, rank, dtype, card, shared)
    kern, call = ((mttkrp3, lambda xx, ff: mttkrp3(xx, *ff)) if len(dims) == 3
                  else (mttkrpn, lambda xx, ff: mttkrpn(xx, ff)))
    before = (kern.launches, splitk.splitk_reduce.launches)
    got = call(x, fs[1:])
    assert kern.launches == before[0] + 1
    assert splitk.splitk_reduce.launches - before[1] in (0, 1)
    _close(got, mttkrpn_plain(x, fs[1:]))
    loop = torch.stack([call(x[b], [_elem(f, b) for f in fs[1:]]) for b in range(batch)])
    assert kern.launches == before[0] + 1 + batch
    _close(got, loop)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_batched_ops_mttkrp_all_modes(card, dtype):
    x, fs = _batch_data(3, (20, 9, 31), 6, dtype, card, seed=1)
    for mode in range(3):
        got = ops.mttkrp(x, fs, mode, out_dtype=torch.float32, batched=True)
        loop = torch.stack([ops.mttkrp(x[b], [f[b] for f in fs], mode, out_dtype=torch.float32)
                            for b in range(3)])
        _close(got, loop)


def test_a_full_wave_batch_runs_unsplit(card):
    """A batch whose CTAs fill a wave alone runs unsplit: no reduction."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    dims, rank = (64, 64, 64), 16
    plan = choose_mttkrp_kernel_blocks(dims, rank, 4)
    assert mttkrp_kernel_grid(dims, rank, plan, sms)[2] > 1
    batch = 2 * sms
    assert mttkrp_kernel_grid(dims, rank, plan, sms, batch)[2] == 1
    x, fs = _batch_data(batch, dims, rank, torch.float32, card, seed=2)
    before = splitk.splitk_reduce.launches
    got = mttkrp3(x, fs[1], fs[2])
    assert splitk.splitk_reduce.launches == before
    _close(got, mttkrpn_plain(x, fs[1:]))


def test_a_batch_beyond_the_grid_limit_raises(card):
    x = torch.zeros((splitk.MAX_BATCH + 1, 1, 1, 1), device=card)
    fs = [torch.zeros((1, 1), device=card)] * 2
    with pytest.raises(ValueError, match="65535"):
        mttkrp3(x, *fs)


@pytest.mark.parametrize("shared", [False, True], ids=["per_element", "shared"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("batch,dims,perm,nkeep", [
    (3, (30, 20, 40), (0, 1, 2), 1),      # canonical, k = 2
    (4, (30, 20, 40), (1, 0, 2), 1),      # in place: the kept axis inner
    (2, (9, 11, 13, 7), (2, 0, 1, 3), 2),  # 4-way, k = 2, kept axes permuted
    (5, (64, 50), (1, 0), 1),             # k = 1
    (1, (12, 10, 8), (0, 2, 1), 0),       # nothing kept
])
def test_batched_partial_is_one_launch(card, batch, dims, perm, nkeep, dtype, shared):
    """The partial kernel on a batch of in-place views: one launch, equal to
    the plain version and to a loop."""
    rank = 16
    rng = np.random.default_rng(4)
    node = torch.as_tensor(rng.standard_normal((batch, *dims, rank), dtype=np.float32))
    node = node.to(card, dtype).permute((0,) + tuple(1 + p for p in perm) + (len(dims) + 1,))
    elem = node.shape[1:-1]
    lead = () if shared else (batch,)
    fs = [torch.as_tensor(rng.standard_normal((*lead, c, rank), dtype=np.float32)).to(card, dtype)
          for c in elem[nkeep:]]
    before = partial.mttkrp_partial.launches
    got = mttkrp_partial(node, fs, batched=True)
    assert partial.mttkrp_partial.launches == before + 1
    _close(got, mttkrp_partial_plain(node, fs, batched=True))
    loop = torch.stack([mttkrp_partial(node[b], [_elem(f, b) for f in fs])
                        for b in range(batch)])
    _close(got, loop)


def test_batched_partial_width_sees_the_batch_stride(card):
    """Element strides that take 16-byte loads but a batch stride that does
    not: the plan loads one element at a time, and the result holds."""
    batch, rows, c, rank = 3, 40, 30, 8
    buf = torch.randn(batch * (rows * c * rank + 2), device=card)
    node = buf.as_strided((batch, rows, c, rank), (rows * c * rank + 2, c * rank, rank, 1))
    fs = [torch.randn((c, rank), device=card)]
    assert partial.default_plan(node[0], fs).vec == 4
    assert partial.default_plan(node, fs, batched=True).vec == 1
    _close(mttkrp_partial(node, fs, batched=True), mttkrp_partial_plain(node, fs, batched=True))


@pytest.mark.parametrize("shared", [False, True], ids=["per_element", "shared"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("batch,dims,ranks", [
    (3, (20, 30, 17), (5, 8)), (1, (40, 33, 70), (16, 16)), (4, (9, 11, 13, 7), (3, 4, 5)),
    (6, (50, 21), (7,)), (2, (5, 7, 9), (2, 3)),
])
def test_batched_multi_ttm_kernel_is_one_launch(card, batch, dims, ranks, dtype, shared):
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((batch, *dims), dtype=np.float32)).to(card, dtype)
    lead = () if shared else (batch,)
    mats = [torch.as_tensor(rng.standard_normal((*lead, c, r), dtype=np.float32)).to(card, dtype)
            for c, r in zip(dims[1:], ranks)]
    before = multi_ttm_keep.launches
    got = multi_ttm_keep(x, mats, batched=True)
    assert multi_ttm_keep.launches == before + 1
    _close(got, multi_ttm_keep_plain(x, mats, batched=True))
    loop = torch.stack([multi_ttm_keep(x[b], [_elem(m, b) for m in mats]) for b in range(batch)])
    _close(got, loop)


@pytest.mark.parametrize("dims", [(12, 9, 15), (6, 5, 7, 4)])
def test_batched_engine_calls_match_einsum(card, dims):
    """Batched mttkrp, contract_partial and multi_ttm on cuda against einsum,
    each one kernel launch."""
    batch, rank = 4, 6
    cu = repro_torch.ExecutionContext.create("cuda")
    es = repro_torch.ExecutionContext.create("einsum")
    x, fs = _batch_data(batch, dims, rank, torch.float32, card, seed=6)
    n = len(dims)
    for mode in range(n):
        _close(repro_torch.mttkrp(x, fs, mode, ctx=cu), repro_torch.mttkrp(x, fs, mode, ctx=es))
    counted = (mttkrp3, mttkrpn, partial.mttkrp_partial, multi_ttm_keep)
    for modes, drop, has_rank in [(tuple(range(n)), (n - 1,), False),
                                  (tuple(range(n)), (0,), True), ((0, n - 1), (n - 1,), True)]:
        shape = tuple(dims[m] for m in modes) + ((rank,) if has_rank else ())
        node = x if not has_rank and len(modes) == n else torch.randn((batch, *shape),
                                                                      device=card)
        before = sum(k.launches for k in counted)
        got = repro_torch.contract_partial(node, fs, modes, drop, has_rank, ctx=cu)
        assert sum(k.launches for k in counted) == before + 1
        _close(got, repro_torch.contract_partial(node, fs, modes, drop, has_rank, ctx=es))
    mats = [f[..., :3] for f in fs]
    for keep in [None, *range(n)]:
        ms = [None if k == keep else m for k, m in enumerate(mats)]
        before = multi_ttm_keep.launches
        got = repro_torch.multi_ttm(x, ms, keep, ctx=cu)
        assert multi_ttm_keep.launches == before + 1
        _close(got, repro_torch.multi_ttm(x, ms, keep, ctx=es))


def test_batched_cp_sweep_launches_n_a_sweep(card):
    """cp_als_batched on cuda: N MTTKRP launches an iteration, whatever B."""
    for batch in (1, 5):
        x, fs = _batch_data(batch, (20, 18, 16), 4, torch.float32, card, seed=7)
        ctx = repro_torch.ExecutionContext.create("cuda")
        before = mttkrp3.launches
        res = repro_torch.cp_als_batched(x, 4, 3, init_factors=fs, ctx=ctx)
        assert mttkrp3.launches == before + 9
        ref = repro_torch.cp_als_batched(x, 4, 3, init_factors=fs,
                                         ctx=repro_torch.ExecutionContext.create("einsum"))
        assert float((res.fits - ref.fits).abs().max()) < 1e-4


def test_batched_hooi_sweep_launches_n_a_sweep(card):
    x = torch.randn((3, 20, 18, 16), device=card)
    before = multi_ttm_keep.launches
    res = repro_torch.tucker_hooi_batched(x, (4, 3, 2), 2,
                                          ctx=repro_torch.ExecutionContext.create("cuda"))
    assert multi_ttm_keep.launches == before + 6
    ref = repro_torch.tucker_hooi_batched(x, (4, 3, 2), 2,
                                          ctx=repro_torch.ExecutionContext.create("einsum"))
    assert float((res.fits - ref.fits).abs().max()) < 1e-4


# ---------------------------------------------------------------------------
# serving and tuning on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    """A throwaway port tune cache for the test."""
    path = str(tmp_path / "plans.json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", path)
    return path


def test_server_makes_one_batched_launch_a_contraction_a_bucket(card, monkeypatch):
    from repro_torch.engine import batch as batch_mod
    from repro_torch.launch.serve import DecompositionServer

    per_call = []
    real = batch_mod.cp_als_batched

    def counted(xs, *a, **kw):
        before = (mttkrp3.launches, mttkrpn.launches)
        res = real(xs, *a, **kw)
        per_call.append((xs.ndim - 1, int(res.n_iters.max()),
                         mttkrp3.launches - before[0], mttkrpn.launches - before[1]))
        return res

    monkeypatch.setattr(batch_mod, "cp_als_batched", counted)
    rng = np.random.default_rng(3)
    shapes = [(30, 27, 25), (32, 29, 31), (25, 32, 28), (14, 15, 13, 16), (16, 10, 15, 12)]
    xs = [torch.as_tensor(rng.standard_normal(s, dtype=np.float32)).to(card) for s in shapes]
    outs = {}
    for backend in ("cuda", "einsum"):
        srv = DecompositionServer(repro_torch.ExecutionContext.create(backend), n_iters=4,
                                  tol=0.0)
        for i, x in enumerate(xs):
            srv.submit(x, 3, request_id=f"r{i}")
        outs[backend] = srv.flush()
    # the cuda server's two buckets: one batched call each, N launches an iteration
    assert sorted(per_call[:2]) == [(3, 4, 12, 0), (4, 4, 0, 16)]
    for rid, r in outs["cuda"].items():
        assert abs(r.fit - outs["einsum"][rid].fit) < 1e-4


def test_auto_on_a_miss_launches_the_kernel_with_the_choosers_plan(card, tune_cache,
                                                                   monkeypatch):
    seen = []
    real = ops.mttkrp

    def spy(*a, **kw):
        seen.append(kw.get("plan"))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "mttkrp", spy)
    x = torch.randn((40, 30, 20), device=card)
    fs = [torch.randn((d, 8), device=card) for d in x.shape]
    auto = repro_torch.ExecutionContext.create("auto")
    before = mttkrp3.launches
    got = repro_torch.mttkrp(x, fs, 1, ctx=auto)
    assert mttkrp3.launches == before + 1
    assert seen == [choose_mttkrp_kernel_blocks((30, 40, 20), 8, 4)]
    _close(got, repro_torch.mttkrp(x, fs, 1, ctx=repro_torch.ExecutionContext.create("einsum")))
    before = multi_ttm_keep.launches
    repro_torch.multi_ttm(x, [f[:, :4] for f in fs], 0, ctx=auto)
    assert multi_ttm_keep.launches == before + 1
    before = (sweep.fused_pair.launches, mttkrp_partial.launches)
    repro_torch.cp_als(x, 8, 1, sweep="auto", ctx=auto)  # a miss: fused
    assert (sweep.fused_pair.launches, mttkrp_partial.launches) == (before[0] + 1,
                                                                    before[1] + 1)


def test_a_cached_kernel_plan_is_replayed_exactly(card, tune_cache, monkeypatch):
    from repro_torch.tune import cache as tcache

    x = torch.randn((70, 30, 20), device=card)
    fs = [torch.randn((d, 8), device=card) for d in x.shape]
    pinned = MTTKRPKernelPlan(64, 32, 16, 2)
    assert pinned != choose_mttkrp_kernel_blocks(tuple(x.shape), 8, 4)
    key = tcache.cache_key(tuple(x.shape), 8, 0, torch.float32, Memory.h100_smem())
    tcache.default_cache().put(key, tcache.CacheEntry("cuda", tcache.plan_to_dict(pinned),
                                                      variant="generic"))
    seen = []
    real = ops.mttkrp

    def spy(*a, **kw):
        seen.append((kw.get("plan"), kw.get("variant")))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "mttkrp", spy)
    before = (mttkrp3.launches, mttkrpn.launches)
    got = repro_torch.mttkrp(x, fs, 0, ctx=repro_torch.ExecutionContext.create("auto"))
    assert seen == [(pinned, "generic")]
    assert (mttkrp3.launches, mttkrpn.launches) == (before[0], before[1] + 1)
    _close(got, mttkrp3_plain(x, fs[1], fs[2]))


@pytest.mark.parametrize("plan,error", [(MTTKRPKernelPlan(96, 32, 16, 2), ValueError),
                                        (MTTKRPKernelPlan(64, 32, 16, 7), ValueError),
                                        (BlockPlan(8, (8, 8), 8), TypeError)])
def test_a_cached_invalid_plan_is_refused_before_launch(card, tune_cache, plan, error):
    from repro_torch.tune import cache as tcache

    x = torch.randn((70, 30, 20), device=card)
    fs = [torch.randn((d, 8), device=card) for d in x.shape]
    key = tcache.cache_key(tuple(x.shape), 8, 0, torch.float32, Memory.h100_smem())
    tcache.default_cache().put(key, tcache.CacheEntry("cuda", tcache.plan_to_dict(plan)))
    before = (mttkrp3.launches, mttkrpn.launches)
    with pytest.raises(error):
        repro_torch.mttkrp(x, fs, 0, ctx=repro_torch.ExecutionContext.create("auto"))
    assert (mttkrp3.launches, mttkrpn.launches) == before


@pytest.mark.parametrize("fault", ["build", "launch"])
def test_a_failing_kernel_raises_out_of_the_tuner(card, tune_cache, tmp_path, monkeypatch,
                                                  fault):
    """A kernel that does not build or launch raises out of ``tune_mttkrp``:
    no plain executor wins in its place, and nothing is persisted."""
    from repro_torch.kernels import build
    from repro_torch.tune import cache as tcache
    from repro_torch.tune import search

    if fault == "build":  # the library not loaded yet, and no nvcc to build it
        def no_nvcc():
            raise build.KernelBuildError("nvcc not found")

        monkeypatch.delitem(build._LOADED, "mttkrp.cu", raising=False)
        monkeypatch.setattr(build, "_build_dir", tmp_path / "empty")
        monkeypatch.setattr(build, "nvcc_path", no_nvcc)
        error = build.KernelBuildError
    else:  # the launch returns a CUDA error
        def failed(err, what):
            raise RuntimeError(f"{what}: CUDA error 700 at launch")

        monkeypatch.setattr(splitk, "check", failed)
        error = RuntimeError
    x = torch.randn((40, 30, 20), device=card)
    fs = [torch.randn((d, 8), device=card) for d in x.shape]
    with pytest.raises(error):
        search.tune_mttkrp(x, fs, 0, ctx=repro_torch.ExecutionContext.create("auto"),
                           reps=1, warmup=0)
    assert len(tcache.PlanCache(tune_cache)) == 0


def test_ensure_compilation_cache_builds_into_and_loads_from_the_directory(card, tmp_path):
    """Two fresh processes on one directory: the first builds
    ``mttkrp.cu`` there, the second loads that library without ``nvcc``
    (its file is not rewritten)."""
    import json
    import os
    import subprocess
    import sys

    root = Path(__file__).resolve().parents[1]
    cc = tmp_path / "cc"
    code = (
        "import json, sys, torch, repro_torch\n"
        "from repro_torch.kernels import build\n"
        f"ctx = repro_torch.ExecutionContext.create('cuda', compilation_cache={str(cc)!r})\n"
        "used = ctx.ensure_compilation_cache()\n"
        "x = torch.randn((20, 18, 16), device='cuda')\n"
        "fs = [torch.randn((d, 4), device='cuda') for d in x.shape]\n"
        "repro_torch.mttkrp(x, fs, 0, ctx=ctx)\n"
        "print(json.dumps({'used': used, 'loaded': {k: str(v) for k, v in "
        "build.loaded().items()}}))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    runs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env=env, check=True).stdout.strip().splitlines()[-1]
        runs.append(json.loads(out))
        if len(runs) == 1:
            libs = {p: p.stat().st_mtime_ns for p in cc.glob("libmttkrp_*.so")}
    assert runs[0]["used"] == str(cc.resolve())
    assert list(runs[0]["loaded"]) == ["mttkrp.cu"]
    assert Path(runs[0]["loaded"]["mttkrp.cu"]).parent == cc.resolve()
    assert runs[1]["loaded"] == runs[0]["loaded"]
    assert len(libs) == 1 and {p: p.stat().st_mtime_ns for p in libs} == libs


# ---------------------------------------------------------------------------
# observability on the card
# ---------------------------------------------------------------------------

def _contraction_launches() -> dict:
    return {"mttkrp3": mttkrp3.launches, "mttkrpn": mttkrpn.launches,
            "fused_pair": fused_pair.launches, "mttkrp_partial": mttkrp_partial.launches,
            "multi_ttm_keep": multi_ttm_keep.launches}


def test_a_traced_dispatch_records_the_launched_plan(card):
    """A traced ``cuda`` dispatch records the plan its wrapper launched and
    ``kernel_modeled_bytes`` of that plan; the partial kernel's plan is the
    one it chose for the view ``contract_partial`` handed it."""
    from repro_torch.observe import Trace
    from repro_torch.tune.cache import plan_from_dict
    from repro_torch.tune.search import kernel_plan_bytes, partial_canon_shape

    dims, rank = (70, 60, 50), 8
    x = torch.randn(dims, device=card)
    fs = [torch.randn((d, rank), device=card) for d in dims]
    ctx = repro_torch.ExecutionContext.create("cuda")
    node = repro_torch.contract_partial(x, fs, (0, 1, 2), (0,), False, ctx=ctx)
    with Trace() as t:
        for mode in range(3):
            repro_torch.mttkrp(x, fs, mode, ctx=ctx)
        repro_torch.contract_partial(node, fs, (1, 2), (2,), True, ctx=ctx)
        repro_torch.multi_ttm(x, [f[:, :4] for f in fs], 1, ctx=ctx)
    events = t.events
    for mode, e in enumerate(events[:3]):
        canon = (dims[mode],) + tuple(d for k, d in enumerate(dims) if k != mode)
        plan = plan_from_dict(e["plan"])
        assert plan == choose_mttkrp_kernel_blocks(canon, rank, 4)
        assert e["kernel_modeled_bytes"] == kernel_plan_bytes(plan, canon, rank, 4)
    view = node.permute(0, 1, 2)
    want = partial.default_plan(view, [fs[2]])
    assert plan_from_dict(events[3]["plan"]) == want
    assert events[3]["kernel_modeled_bytes"] == kernel_plan_bytes(
        want, partial_canon_shape(node.shape, (1, 2), (2,)), rank, 4)
    assert plan_from_dict(events[4]["plan"]) == choose_multi_ttm_kernel_blocks(
        (60, 70, 50), (4, 4), 4)


def test_a_graph_captured_under_a_trace_records_nothing(card):
    from repro_torch.observe import Trace

    x = torch.randn((64, 48, 40), device=card)
    fs = [torch.randn((d, 8), device=card) for d in x.shape]
    ctx = repro_torch.ExecutionContext.create("cuda", observe=True)
    with Trace() as t:
        want = repro_torch.mttkrp(x, fs, 1, ctx=ctx)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            repro_torch.mttkrp(x, fs, 1, ctx=ctx)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            out = repro_torch.mttkrp(x, fs, 1, ctx=ctx)
        assert len(t) == 2  # the eager calls; the capture recorded nothing
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_audit_on_the_card_counts_the_wrappers_bytes(card):
    """The op-boundary count is the same on the card as on CPU copies of
    the operands: the kernels' reports stand where the plain versions ran."""
    from repro_torch.observe import audit_mttkrp, audit_multi_ttm
    from repro_torch.observe.bounds_audit import OpBoundaries

    dims, rank = (70, 60, 50), 8
    x = torch.randn(dims, device=card)
    fs = [torch.randn((d, rank), device=card) for d in dims]
    on = repro_torch.ExecutionContext.create("cuda")
    off = repro_torch.ExecutionContext.create("cuda", device="cpu")
    for mode in range(3):
        row = audit_mttkrp(x, fs, mode, ctx=on)
        assert row.to_dict() == audit_mttkrp(x.cpu(), [f.cpu() for f in fs], mode,
                                             ctx=off).to_dict()
    mats = [f[:, :4].contiguous() for f in fs]  # .cpu() of a slice would copy it dense
    assert audit_multi_ttm(x, mats, 0, ctx=on).measured_bytes == audit_multi_ttm(
        x.cpu(), [m.cpu() for m in mats], 0, ctx=off).measured_bytes
    with OpBoundaries() as ops:
        repro_torch.mttkrp(x, fs, 0, ctx=on)
    assert [k.name for k in ops.kernels][0] == "mttkrp3" and ops.kernel_bytes >= x.nbytes


@pytest.mark.parametrize("dims,rank", [((40, 36, 32), 8), ((14, 12, 10, 9), 6)])
@pytest.mark.parametrize("sweep", ["per_mode", "fused", "dimtree"])
def test_cuda_dispatches_equal_the_launch_counters(card, dims, rank, sweep):
    """``engine.cuda_dispatches`` counts one a contraction: every launch of
    a contraction kernel (``splitk_reduce`` apart, which follows a split
    one)."""
    from repro_torch.observe import registry
    from repro_torch.observe.metrics import CUDA_DISPATCHES

    x = torch.randn(dims, device=card)
    init = [torch.randn((d, rank), device=card) for d in dims]
    before, counts = registry().snapshot(), _contraction_launches()
    repro_torch.cp_als(x, rank, 2, init_factors=init, sweep=sweep,
                       ctx=repro_torch.ExecutionContext.create("cuda"))
    launched = sum(n - counts[k] for k, n in _contraction_launches().items())
    assert registry().delta(before).get(CUDA_DISPATCHES, 0) == launched > 0


def _dist_tests():
    """``tests/test_torch_distributed.py`` as a module: its worker runs the
    ranks (it imports no JAX at module level)."""
    path = Path(__file__).with_name("test_torch_distributed.py")
    spec = importlib.util.spec_from_file_location("_torch_distributed_worker", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_distributed_alg3_and_cp_sweep_on_the_card(card, tmp_path):
    """Two gloo ranks on the card (CUDA payloads staged through the host):
    Alg 3 on a (2, 1, 1) grid with the ``cuda`` local MTTKRP against the
    sequential ``cuda`` MTTKRP (1e-5), its bytes Eq (12) exactly, and one
    ``cp_als`` sweep on a distributed context against the sequential
    ``cuda`` run from the same factors (fit 1e-5, factors 1e-4)."""
    from repro_torch.core.bounds import par_stationary_cost

    dt = _dist_tests()
    dt.wait_all(dt.spawn_group(str(tmp_path), device="cuda", world=2, cases="card"))
    ranks = [(json.load(open(tmp_path / f"rank{r}.json")),
              dict(np.load(tmp_path / f"rank{r}.npz"))) for r in range(2)]
    data = dict(np.load(tmp_path / "inputs.npz"))
    ctx = repro_torch.ExecutionContext.create("cuda")
    x, fs = dt._factors(data, "a3")
    xt, ft = torch.from_numpy(x).to(card), [torch.from_numpy(f).to(card) for f in fs]
    for mode in range(3):
        key = f"card-alg3-2x1x1-m{mode}"
        got = dt._assemble({"ranks": ranks}, key, (x.shape[mode], fs[0].shape[1]))
        dt._close(got, repro_torch.mttkrp(xt, ft, mode, ctx=ctx).cpu().numpy())
        assert all(m[key]["bytes"] == par_stationary_cost(x.shape, 8, (2, 1, 1), mode) * 4
                   for m, _ in ranks)
    x, init = dt._factors(data, "cp")
    seq = repro_torch.cp_als(torch.from_numpy(x).to(card), dt.CP_RANK, 1, ctx=ctx,
                             init_factors=[torch.from_numpy(f).to(card) for f in init])
    for meta, arrays in ranks:
        np.testing.assert_allclose(meta["card-cp"]["fits"], seq.fits, rtol=0, atol=1e-5)
        assert meta["card-cp"]["launches"]["mttkrp3"] == 3  # one sweep, three modes
        for k in range(3):
            dt._close(arrays[f"card-cp-f{k}"], seq.factors[k].cpu().numpy(), 1e-4)


# --------------------------------------------------------------------------
# the kernel walks against the kernels: grids and the write probe
# --------------------------------------------------------------------------

def _walk_cases():
    """The analyzer's cases that are not the full-size cells (``chip_smoke.py``
    phase 15 probes those): ragged, 2-way, batched, the reference's."""
    from repro_torch.verify.kernels import kernel_cases

    return [c for c in kernel_cases() if not c.label.startswith("cell")]


def _walk_id(case):
    return f"{case.wrapper}-{case.label}-{'x'.join(map(str, case.shape))}-b{case.batch}" + \
        ("-shared" if case.shared else "") + f"-i{case.itemsize}"


@pytest.mark.parametrize("case", _walk_cases(), ids=_walk_id)
def test_library_grid_equals_its_mirror(card, case):
    from repro_torch.verify.probe import check_grid

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    rec = check_grid(case, sms)
    assert rec["equal"], rec


@pytest.mark.parametrize("case", _walk_cases(), ids=_walk_id)
def test_write_probe_counts_every_element_once(card, case):
    from repro_torch.verify.probe import probe_case

    rec = probe_case(case, card, seed=7)
    assert rec["ok"], rec
    assert rec["bit_equal"] and rec["overflow"] == 0 and rec["max_count"] == rec["min_count"] == 1


def test_write_probe_cases_span_the_kernels_shapes():
    from repro_torch.verify.kernels import case_plan, case_walk

    cases = _walk_cases()
    assert {c.wrapper for c in cases} == {"mttkrp3", "mttkrpn", "splitk_reduce", "fused_pair",
                                          "mttkrp_partial", "multi_ttm_keep", "ssd_intra"}
    assert {c.batch for c in cases} >= {1, 16, 65535} and any(c.shared for c in cases)
    assert any(len(c.shape) == 2 for c in cases if c.wrapper == "mttkrpn")
    splits = {case_walk(c).grid[1] > 1 for c in cases if c.wrapper in ("mttkrp3", "mttkrpn")}
    assert splits == {True, False}
    layouts = {case_plan(c).layout for c in cases if c.wrapper == "mttkrp_partial"}
    assert layouts == {"rows", "contract"}


def test_write_probe_reports_a_store_past_the_registered_buffer(card):
    from repro_torch.kernels import build

    lib = build.probe_library("mttkrp.cu")
    n = 3000
    ws = torch.randn((2, n), device=card)
    out = torch.empty(n, device=card)
    counts = torch.zeros(n // 2 + 1, dtype=torch.int32, device=card)
    build.check(lib.repro_write_probe_set(None, 0, 0, None), "probe")
    build.check(lib.repro_write_probe_set(out.data_ptr(), n // 2, 4, counts.data_ptr()),
                "probe")  # half of what the reduction writes
    stream = torch.cuda.current_stream(card).cuda_stream
    build.check(lib.repro_splitk_reduce(ws.data_ptr(), out.data_ptr(), n, 2, stream), "splitk")
    torch.cuda.synchronize(card)
    assert (counts[:-1] == 1).all() and int(counts[-1]) == n - n // 2
    assert torch.equal(out, ws.sum(0))
    build.check(lib.repro_write_probe_set(None, 0, 0, None), "probe")


# -- the MoE FFN: routing held fixed; the hybrid's prefill -------------------

@pytest.mark.parametrize("skewed", [False, True], ids=["routed", "skewed"])
@pytest.mark.parametrize("name", ["olmoe-1b-7b", "granite-moe-3b-a800m", "jamba-v0.1-52b"])
def test_apply_moe_on_the_card_matches_cpu_with_routing_fixed(card, name, skewed):
    """A smoke-sized MoE layer in fp32 on the card against the same weights
    on the CPU, both following the CPU's routing; skewed, expert 0's queue
    overflows and both drop the same choices. No kernel is launched."""
    cfg = replace(get_smoke(name), dtype="float32")
    gen = torch.Generator().manual_seed(9)
    p = moe.init_moe(gen, cfg, torch.float32, "cpu")
    x = torch.randn((2, 320, cfg.d_model), generator=gen)
    if skewed:
        p.router[:, 0] += 8.0 / cfg.d_model
        x += 0.5
    r = moe.route(p, x.reshape(-1, cfg.d_model), cfg.top_k)
    t = x.shape[0] * x.shape[1]
    _, keep = moe.assign(r.ids, cfg.n_experts, moe.capacity(t, cfg.top_k, cfg.n_experts))
    assert bool((~keep).any()) == skewed
    want, want_aux = moe.apply_moe(p, x, cfg, routing=r)
    before = _launch_counts()
    got, aux = moe.apply_moe(copy.deepcopy(p).to(card), x.to(card), cfg,
                             routing=moe.Routing(*(a.to(card) for a in r)))
    assert _launch_counts() == before
    _close(got.cpu(), want)
    assert abs(float(aux) - float(want_aux)) <= 1e-6


def test_jamba_prefill_launches_once_an_ssm_layer(card):
    """jamba's smoke model (one period of 8 layers: attention at 4, the SSM
    elsewhere, MoE at the odd ones) in bf16: a prefill launches ``ssd_intra``
    exactly 7 times, a decode step never."""
    cfg = get_smoke("jamba-v0.1-52b")
    model = init_params(cfg, generator=torch.Generator(device=card).manual_seed(10))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=card)
    before = ssd_intra.launches
    lg, aux = forward(model, cfg, {"tokens": tokens}, mode="prefill", logits_positions="last")
    assert ssd_intra.launches == before + 7
    assert lg.shape == (2, 1, cfg.padded_vocab) and bool(torch.isfinite(lg).all())
    assert float(aux) > 0
    state = init_decode_state(model, cfg, 2, 16)
    for t in range(3):
        lg, state = decode_step(model, cfg, state, tokens[:, t:t + 1])
    assert ssd_intra.launches == before + 7 and bool(torch.isfinite(lg).all())
