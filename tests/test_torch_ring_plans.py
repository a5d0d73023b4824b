"""The fused pair and Multi-TTM kernels' own plans, and their walks, on the CPU.

Both kernels run on the ``cp.async`` ring and tensor cores of
``csrc/ring.cuh``. The pair takes the MTTKRP kernel's plan type
(``MTTKRPKernelPlan``) against its own shared memory
(``pair_kernel_smem_bytes``); the Multi-TTM kernel has its own
(``MultiTTMKernelPlan``, ``multi_ttm_kernel_smem_bytes``). Both mirrors of
the C layouts are pinned here, the choosers checked at the main shapes, and
each kernel's walk emulated in float32 and held against the reference's
Pallas kernel in interpret mode to 1e-5 of the largest output magnitude
(float32 on both sides, different summation orders):

* the pair: per row tile and split (split s takes the leading index tuples
  s, s + S, ...), each tuple's chunks of the last axis added into its P
  tile, which is stored and added, scaled by the leading factors' rows,
  into the split's B0 slab; the slabs are added in slab order;
* the Multi-TTM: per i and split (a contiguous range of the i's tiles), each
  tile of ``block_m`` consecutive ``c_{k-1}`` rows multiplied by ``A_k``
  chunk by chunk, then folded through ``A_{k-1}`` and the outer weights
  into the i's output tile; with one contraction axis a tile is
  ``block_m`` consecutive rows of X and its product is the output.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
import repro_torch.engine.execute as execute
import repro_torch.engine.plan as tp
from repro.engine.plan import BlockPlan as JPlan
from repro.kernels.multi_ttm import multi_ttm_keep_pallas
from repro.kernels.sweep import fused_pair_canonical_pallas
from repro_torch.kernels import splitk
from repro_torch.kernels.multi_ttm import multi_ttm_keep, multi_ttm_keep_plain
from repro_torch.kernels.sweep import fused_pair, fused_pair_plain

F32_TOL = 1e-5

PAIR_SHAPES = [((1000, 1000, 1000), 64), ((180, 180, 180, 180), 32), ((5, 7, 9), 1),
               ((33, 17, 70), 7), ((300, 41, 257), 130), ((4, 5, 3, 2, 6), 5), ((1, 3, 2), 200),
               ((70, 2, 2, 2, 2, 2, 2, 3), 16)]
TTM_SHAPES = [((1000, 1000, 1000), (32, 32)), ((180, 180, 180, 180), (16, 16, 16)),
              ((5, 7, 9), (2, 3)), ((130, 9, 200), (8, 3)), ((40, 21, 19, 35), (5, 4, 6)),
              ((4, 5, 3, 2, 6), (2, 2, 1, 3)), ((300, 70), (9,)), ((60, 9, 300), (3, 130)),
              ((180, 180, 180, 180), (32, 33, 34))]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= F32_TOL * float(np.abs(want).max())


# -- the plans -------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,rank", PAIR_SHAPES)
def test_pair_plan_fits_and_reads_x_once(shape, rank, itemsize):
    plan = tp.choose_pair_kernel_blocks(shape, rank, itemsize)
    assert isinstance(plan, tp.MTTKRPKernelPlan)
    plan.check(itemsize)
    smem = tp.pair_kernel_smem_bytes(plan, itemsize, len(shape) - 1)
    assert smem <= tp.SMEM_PER_CTA_MAX
    assert smem <= tp.SMEM_BUDGET  # two CTAs share an SM at every shape here
    assert plan.block_r >= min(rank, 128)  # one rank tile up to R = 128: X read once
    rows, rtiles, splits = tp.pair_kernel_grid(shape, rank, plan)
    npf = math.prod(shape[1:-1])
    assert 1 <= splits <= npf  # whole tuples only
    assert splits == npf or rows * rtiles * splits >= tp.CTAS_PER_SM * tp.H100_SMS


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,ranks", TTM_SHAPES)
def test_multi_ttm_plan_fits(shape, ranks, itemsize):
    plan = tp.choose_multi_ttm_kernel_blocks(shape, ranks, itemsize)
    assert isinstance(plan, tp.MultiTTMKernelPlan)
    plan.check(itemsize)
    assert tp.multi_ttm_kernel_smem_bytes(plan, itemsize, ranks) <= tp.SMEM_PER_CTA_MAX
    assert plan.block_r >= min(ranks[-1], 128)
    units, rtiles, splits = tp.multi_ttm_kernel_grid(shape, ranks, plan)
    if len(shape) == 2:
        assert (units, splits) == (math.ceil(shape[0] / plan.block_m), 1)
    else:
        tiles = math.prod(shape[1:-2]) * math.ceil(shape[-2] / plan.block_m)
        assert units == shape[0] and 1 <= splits <= tiles


def test_main_shape_plans():
    """The plans the card runs at the main shapes (PERF.md): the pair's B0
    accumulators (32 KiB at R=64) narrow its fp32 chunks to 128 bytes at
    1000^3 so that two CTAs share an SM; Multi-TTM takes C_{k-1} = 180 in
    one 192-row tile."""
    assert tp.choose_pair_kernel_blocks((1000,) * 3, 64, 4) == tp.MTTKRPKernelPlan(128, 32, 64, 2)
    assert tp.choose_pair_kernel_blocks((1000,) * 3, 64, 2) == tp.MTTKRPKernelPlan(128, 64, 64, 2)
    assert tp.choose_pair_kernel_blocks((180,) * 4, 32, 4) == tp.MTTKRPKernelPlan(128, 64, 32, 2)
    assert tp.pair_kernel_grid((1000,) * 3, 64, tp.MTTKRPKernelPlan(128, 32, 64, 2)) == (8, 1, 33)
    assert tp.pair_kernel_grid((180,) * 4, 32, tp.MTTKRPKernelPlan(128, 64, 32, 2)) == (
        2, 1, 132)
    assert tp.choose_multi_ttm_kernel_blocks((180,) * 4, (16,) * 3) == tp.MultiTTMKernelPlan(
        192, 32, 16, 2)
    assert tp.choose_multi_ttm_kernel_blocks((60, 200, 257), (16, 16)).block_m == 128


@pytest.mark.parametrize("plan,itemsize,nc,want", [
    # MTTKRP ring + block_i * block_r fp32 B0 accumulators
    (tp.MTTKRPKernelPlan(128, 32, 64, 2), 4, 2, 2 * (128 * 144 + 32 * 288 + 256) + 128 * 64 * 4),
    (tp.MTTKRPKernelPlan(128, 64, 64, 2), 2, 2, 2 * (128 * 144 + 64 * 144 + 128) + 128 * 64 * 4),
    (tp.MTTKRPKernelPlan(64, 16, 16, 3), 4, 3, 3 * (64 * 80 + 16 * 96 + 2 * 64) + 64 * 16 * 4),
])
def test_pair_smem_mirror_layout(plan, itemsize, nc, want):
    assert tp.pair_kernel_smem_bytes(plan, itemsize, nc) == want


@pytest.mark.parametrize("plan,itemsize,ranks,want", [
    # ring (no rows beside A_k's) | T | A_{k-1} rows (R_{k-1} padded to 4) | w | V | O
    (tp.MultiTTMKernelPlan(128, 32, 32, 2), 4, (32, 32),
     2 * (128 * 144 + 32 * 160) + 4 * (128 * 36 + 128 * 32 + 4 + 32 * 32 + 32 * 32)),
    (tp.MultiTTMKernelPlan(128, 32, 16, 3), 4, (16, 16, 16),
     3 * (128 * 144 + 32 * 96) + 4 * (128 * 20 + 128 * 16 + 16 + 16 * 16 + 16 * 16 * 16)),
    (tp.MultiTTMKernelPlan(64, 64, 16, 2), 2, (7,), 2 * (64 * 144 + 64 * 48)),
    (tp.MultiTTMKernelPlan(192, 32, 16, 2), 4, (16, 16, 16),
     2 * (192 * 144 + 32 * 96) + 4 * (192 * 20 + 192 * 16 + 16 + 16 * 16 + 16 * 16 * 16)),
    (tp.MultiTTMKernelPlan(64, 8, 64, 2), 4, (3, 2, 130),
     2 * (64 * 48 + 8 * 288) + 4 * (64 * 68 + 64 * 4 + 4 + 4 * 64 + 3 * 2 * 64)),
])
def test_multi_ttm_smem_mirror_layout(plan, itemsize, ranks, want):
    assert tp.multi_ttm_kernel_smem_bytes(plan, itemsize, ranks) == want


@pytest.mark.parametrize("plan,itemsize", [
    (tp.MultiTTMKernelPlan(32, 32, 64, 2), 4),    # block_m
    (tp.MultiTTMKernelPlan(256, 32, 64, 2), 4),   # block_m
    (tp.MultiTTMKernelPlan(128, 32, 48, 2), 4),   # block_r
    (tp.MultiTTMKernelPlan(128, 128, 64, 2), 4),  # 512-byte chunks
    (tp.MultiTTMKernelPlan(128, 32, 64, 5), 4),   # five stages
])
def test_multi_ttm_plan_check_rejects_what_the_kernel_does_not_take(plan, itemsize):
    with pytest.raises(ValueError, match="Multi-TTM kernel takes"):
        plan.check(itemsize)


def test_kernel_plan_takes_each_kernels_own_type_only():
    x = torch.zeros((10, 9, 8))
    pinned = tp.MultiTTMKernelPlan(64, 32, 16, 3)
    kw = {"choose": tp.choose_multi_ttm_kernel_blocks, "cls": tp.MultiTTMKernelPlan}
    assert splitk.kernel_plan("t", x, (4, 5), None, **kw) == \
        tp.choose_multi_ttm_kernel_blocks((10, 9, 8), (4, 5), 4)
    assert splitk.kernel_plan("t", x, (4, 5), pinned, **kw) is pinned
    with pytest.raises(TypeError, match="MultiTTMKernelPlan"):
        splitk.kernel_plan("t", x, (4, 5), tp.MultiTTMPlan(8, (8, 8), (4, 5)), **kw)
    with pytest.raises(TypeError, match="MTTKRPKernelPlan"):
        splitk.kernel_plan("t", x, 5, tp.BlockPlan(8, (8, 8), 16),
                           choose=tp.choose_pair_kernel_blocks)


def test_cpu_tensors_ignore_the_plans():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6, 5, 4), dtype=np.float32))
    fs = [torch.from_numpy(rng.standard_normal((d, 3), dtype=np.float32)) for d in (5, 4)]
    before = (fused_pair.launches, multi_ttm_keep.launches)
    for plan in (tp.BlockPlan(8, (4, 4), 16), tp.MTTKRPKernelPlan(64, 32, 16, 2)):
        got, want = fused_pair(x, fs, plan=plan), fused_pair_plain(x, fs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for plan in (tp.MultiTTMPlan(8, (4, 4), (3, 3)), tp.MultiTTMKernelPlan(64, 32, 16, 2)):
        assert torch.equal(multi_ttm_keep(x, fs, plan=plan), multi_ttm_keep_plain(x, fs))
    assert (fused_pair.launches, multi_ttm_keep.launches) == before


def test_engine_does_not_plan_the_pair_with_the_sweep_planner(monkeypatch):
    """On ``cuda`` the pair kernel plans itself: ``ctx.memory`` no longer
    picks a reference-shaped plan for it."""
    seen = []
    real = execute.fused_pair_canonical
    monkeypatch.setattr(execute, "fused_pair_canonical",
                        lambda x, fs, **kw: seen.append(kw.get("plan")) or real(x, fs, **kw))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((6, 5, 4), dtype=np.float32))
    fs = [torch.from_numpy(rng.standard_normal((d, 3), dtype=np.float32)) for d in (6, 5, 4)]
    ctx = repro_torch.ExecutionContext.create(
        "cuda", device="cpu", memory=tp.Memory.abstract(4096, itemsize=4))
    b0, p = execute.fused_pair(x, fs, ctx)
    want = fused_pair_plain(x, fs[1:])
    _close(b0.numpy(), want[0].numpy())
    _close(p.numpy(), want[1].numpy())
    assert seen == [None]


# -- the walks, against the Pallas kernels -----------------------------------------

def _pair_walk(x, fs, plan, sms=tp.H100_SMS):
    """The pair kernel's walk in float32 (see the module docstring)."""
    shape, rank = tuple(x.shape), fs[0].shape[1]
    npf, c_last = math.prod(shape[1:-1]), shape[-1]
    _, _, splits = tp.pair_kernel_grid(shape, rank, plan, sms)
    xv = x.reshape(shape[0], npf, c_last)
    p = torch.empty((shape[0], npf, rank))
    slabs = torch.zeros((splits, shape[0], rank))
    for s in range(splits):
        for pf in range(s, npf, splits):
            tile = torch.zeros((shape[0], rank))
            for off in range(0, c_last, plan.block_k):
                tile += xv[:, pf, off:off + plan.block_k] @ fs[-1][off:off + plan.block_k]
            p[:, pf] = tile
            pvec = torch.ones(rank)
            for f, dgt in zip(fs[:-1], np.unravel_index(pf, shape[1:-1])):
                pvec = pvec * f[int(dgt)]
            slabs[s] += pvec * tile
    return slabs.sum(0), p.reshape(shape[:-1] + (rank,))


def _ttm_walk(x, mats, plan, sms=tp.H100_SMS):
    """The Multi-TTM kernel's walk in float32 (see the module docstring)."""
    shape, k = tuple(x.shape), len(mats)
    ranks = tuple(m.shape[1] for m in mats)
    c_last, bm = shape[-1], plan.block_m

    def t_of(rows):  # the tile's T, chunk by chunk
        t = torch.zeros((rows.shape[0], ranks[-1]))
        for off in range(0, c_last, plan.block_k):
            t += rows[:, off:off + plan.block_k] @ mats[-1][off:off + plan.block_k]
        return t

    if k == 1:
        return torch.cat([t_of(x[i0:i0 + bm]) for i0 in range(0, shape[0], bm)])
    _, _, splits = tp.multi_ttm_kernel_grid(shape, ranks, plan, sms)
    m, n_outer = shape[-2], math.prod(shape[1:-2])
    mtiles = math.ceil(m / bm)
    xv = x.reshape(shape[0], n_outer, m, c_last)
    out = torch.zeros((splits, shape[0], math.prod(ranks)))
    for i in range(shape[0]):
        nq = n_outer * mtiles
        for s in range(splits):
            o = torch.zeros((math.prod(ranks[:-2]), ranks[-2], ranks[-1]))
            for q in range(s * nq // splits, (s + 1) * nq // splits):
                uo, m0 = divmod(q, mtiles)
                m0 *= bm
                v = mats[-2][m0:m0 + bm].T @ t_of(xv[i, uo, m0:m0 + bm])
                w = torch.ones(())
                for mat, dgt in zip(mats[:-2], np.unravel_index(uo, shape[1:-2])):
                    w = torch.outer(w.reshape(-1), mat[int(dgt)]).reshape(-1)
                o += w.reshape(-1, 1, 1) * v
            out[s, i] = o.reshape(-1)
    return out.sum(0)


@pytest.mark.parametrize("dims,rank,plan,jplan", [
    ((11, 7, 9), 5, tp.MTTKRPKernelPlan(64, 8, 16, 2), JPlan(4, (2, 4), 2)),
    ((6, 13, 10), 3, tp.MTTKRPKernelPlan(64, 16, 16, 3), JPlan(8, (8, 8), 4)),
    ((5, 4, 3, 7), 4, tp.MTTKRPKernelPlan(64, 8, 16, 2), JPlan(2, (3, 2, 4), 4)),
    ((70, 9, 20), 6, tp.MTTKRPKernelPlan(64, 8, 16, 2), JPlan(8, (8, 8), 8)),
])
def test_pair_walk_matches_pallas(dims, rank, plan, jplan):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(dims, dtype=np.float32)
    fs = [rng.standard_normal((d, rank), dtype=np.float32) for d in dims[1:]]
    jb0, jp_ = fused_pair_canonical_pallas(jnp.asarray(x), [jnp.asarray(f) for f in fs],
                                           plan=jplan, interpret=True)
    b0, p = _pair_walk(torch.from_numpy(x), [torch.from_numpy(f) for f in fs], plan)
    _close(b0.numpy(), jb0)
    _close(p.numpy(), jp_)


@pytest.mark.parametrize("dims,ranks,plan,bi,bc", [
    ((16, 8, 128), (4, 3), tp.MultiTTMKernelPlan(64, 32, 16, 2), 8, (8, 128)),
    ((8, 4, 6, 16), (2, 3, 2), tp.MultiTTMKernelPlan(64, 8, 16, 2), 4, (2, 3, 8)),
    ((4, 3, 70, 24), (2, 3, 5), tp.MultiTTMKernelPlan(64, 8, 16, 3), 4, (3, 70, 8)),
    ((3, 2, 150, 20), (2, 3, 4), tp.MultiTTMKernelPlan(192, 8, 16, 2), 3, (2, 150, 4)),
    ((24, 16), (5,), tp.MultiTTMKernelPlan(64, 8, 16, 2), 8, (8,)),
])
def test_multi_ttm_walk_matches_pallas(dims, ranks, plan, bi, bc):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(dims, dtype=np.float32)
    mats = [rng.standard_normal((d, r), dtype=np.float32) for d, r in zip(dims[1:], ranks)]
    want = multi_ttm_keep_pallas(jnp.asarray(x), [jnp.asarray(m) for m in mats], block_i=bi,
                                 block_contract=bc, interpret=True)
    got = _ttm_walk(torch.from_numpy(x), [torch.from_numpy(m) for m in mats], plan)
    _close(got.numpy(), want)
