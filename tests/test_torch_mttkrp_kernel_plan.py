"""The Hopper MTTKRP kernel's own plan, on the CPU.

``choose_mttkrp_kernel_blocks`` plans the kernel against its real shared
memory (``mttkrp_kernel_smem_bytes``, the mirror of the C layout), and the
engine no longer derives a reference-shaped ``BlockPlan`` for it on
``cuda``. The kernel's walk over K (chunks of the last axis under one
leading index tuple, split over CTAs, each chunk's partial sums scaled by the
product of the leading factors' rows) is emulated here in float32 and held
against the reference's Pallas kernel in interpret mode to 1e-5 of the
largest output magnitude (float32 on both sides, different summation orders).
"""

import math
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
import repro_torch.engine.execute as execute
import repro_torch.engine.plan as plan_mod
from repro.engine.plan import BlockPlan as JPlan
from repro.kernels.ops import mttkrp_canonical_pallas
from repro_torch.engine.plan import (
    CTAS_PER_SM,
    H100_SMS,
    MTTKRP_CHUNK_BYTES,
    SMEM_BUDGET,
    SMEM_PER_CTA_MAX,
    BlockPlan,
    Memory,
    MTTKRPKernelPlan,
    choose_mttkrp_kernel_blocks,
    mttkrp_kernel_grid,
    mttkrp_kernel_smem_bytes,
)
from repro_torch.kernels import splitk
from repro_torch.kernels.mttkrp3 import mttkrp3, mttkrp3_plain
from repro_torch.kernels.mttkrpn import mttkrpn, mttkrpn_plain

F32_TOL = 1e-5

MAIN = [((1000, 1000, 1000), 64), ((180, 180, 180, 180), 32), ((1000000, 1000), 64),
        ((32400, 180, 180), 32)]
RAGGED = [((5, 7, 9), 1), ((33, 17, 70), 7), ((130, 9, 201), 64), ((300, 41, 257), 130),
          ((4, 5, 3, 2, 6), 5), ((9, 5), 3), ((1, 3, 2), 200), ((70, 2, 2, 2, 2, 2, 2, 3), 16)]


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,rank", MAIN + RAGGED)
def test_default_plan_fits_and_reads_x_once(shape, rank, itemsize):
    plan = choose_mttkrp_kernel_blocks(shape, rank, itemsize)
    plan.check(itemsize)
    smem = mttkrp_kernel_smem_bytes(plan, itemsize, len(shape) - 1)
    assert smem <= SMEM_PER_CTA_MAX
    assert smem <= SMEM_BUDGET  # two CTAs share an SM at every shape here
    assert plan.stages >= 2
    assert plan.block_k * itemsize in MTTKRP_CHUNK_BYTES
    if rank <= 128:
        assert plan.block_r >= rank  # one rank tile: X is read once
    else:
        assert plan.block_r == 128


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,rank", MAIN)
def test_split_rule_fills_the_card(shape, rank, itemsize):
    plan = choose_mttkrp_kernel_blocks(shape, rank, itemsize)
    rows, rtiles, splits = mttkrp_kernel_grid(shape, rank, plan, H100_SMS)
    assert rows == math.ceil(shape[0] / plan.block_i) and rtiles == 1
    assert rows * rtiles * splits >= CTAS_PER_SM * H100_SMS
    chunks = math.prod(shape[1:-1]) * math.ceil(shape[-1] / plan.block_k)
    assert splits <= chunks


def test_main_shape_plans():
    """The plans the card runs at the main shapes (PERF.md): 128-row tiles,
    256-byte chunks, two stages, so two CTAs share each SM."""
    assert choose_mttkrp_kernel_blocks((1000,) * 3, 64, 4) == MTTKRPKernelPlan(128, 64, 64, 2)
    assert choose_mttkrp_kernel_blocks((1000,) * 3, 64, 2) == MTTKRPKernelPlan(128, 128, 64, 2)
    assert choose_mttkrp_kernel_blocks((180,) * 4, 32, 4) == MTTKRPKernelPlan(128, 64, 32, 2)
    assert mttkrp_kernel_grid((1000,) * 3, 64, MTTKRPKernelPlan(128, 64, 64, 2)) == (8, 1, 33)
    assert mttkrp_kernel_grid((180,) * 4, 32, MTTKRPKernelPlan(128, 64, 32, 2)) == (2, 1, 132)
    assert mttkrp_kernel_grid((10 ** 6, 1000), 64, MTTKRPKernelPlan(128, 64, 64, 2)) == (
        7813, 1, 1)


@pytest.mark.parametrize("plan,itemsize,nc,want", [
    # stages * (rows * (bk * size + 16) + bk * (br * size + skew) + (nc - 1) * br * size)
    (MTTKRPKernelPlan(128, 64, 64, 2), 4, 2, 2 * (128 * 272 + 64 * 288 + 256)),
    (MTTKRPKernelPlan(128, 128, 64, 2), 2, 2, 2 * (128 * 272 + 128 * 144 + 128)),
    (MTTKRPKernelPlan(64, 8, 16, 4), 4, 1, 4 * (64 * 48 + 8 * 96)),
    (MTTKRPKernelPlan(64, 16, 128, 3), 2, 7, 3 * (64 * 48 + 16 * 272 + 6 * 256)),
])
def test_smem_mirror_layout(plan, itemsize, nc, want):
    assert mttkrp_kernel_smem_bytes(plan, itemsize, nc) == want


@pytest.mark.parametrize("plan,itemsize", [
    (MTTKRPKernelPlan(32, 32, 64, 2), 4),    # block_i
    (MTTKRPKernelPlan(128, 32, 48, 2), 4),   # block_r
    (MTTKRPKernelPlan(128, 24, 64, 2), 4),   # 96-byte chunks
    (MTTKRPKernelPlan(128, 128, 64, 2), 4),  # 512-byte chunks
    (MTTKRPKernelPlan(128, 32, 64, 1), 4),   # one stage
    (MTTKRPKernelPlan(64, 8, 16, 5), 4),     # five stages
    (MTTKRPKernelPlan(128, 8, 64, 2), 2),    # 16-byte chunks
])
def test_plan_check_rejects_what_the_kernel_does_not_take(plan, itemsize):
    with pytest.raises(ValueError, match="MTTKRP kernel takes"):
        plan.check(itemsize)


def test_kernel_plan_takes_its_own_type_only():
    x = torch.zeros((10, 9, 8))
    assert splitk.kernel_plan("t", x, 5, None) == choose_mttkrp_kernel_blocks((10, 9, 8), 5, 4)
    pinned = MTTKRPKernelPlan(64, 32, 16, 3)
    assert splitk.kernel_plan("t", x, 5, pinned) is pinned
    with pytest.raises(TypeError, match="MTTKRPKernelPlan"):
        splitk.kernel_plan("t", x, 5, BlockPlan(8, (8, 8), 16))


@pytest.mark.parametrize("run_bytes,ptrs,want", [
    (4000, [256], 16), (720, [256, 512], 16), (360, [256], 8), (28, [0, 28], 4),
    (14, [0], 0), (4000, [260], 4), (4000, [258], 0),
])
def test_copy_width(run_bytes, ptrs, want):
    assert splitk.copy_width(run_bytes, ptrs) == want


@pytest.mark.parametrize("plan", [BlockPlan(8, (4, 4), 16), MTTKRPKernelPlan(64, 32, 16, 2)])
def test_cpu_tensors_ignore_the_plan(plan):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6, 5, 4), dtype=np.float32))
    a, b = (torch.from_numpy(rng.standard_normal((d, 3), dtype=np.float32)) for d in (5, 4))
    assert torch.equal(mttkrp3(x, a, b, plan=plan), mttkrp3_plain(x, a, b))
    assert torch.equal(mttkrpn(x, [a, b], plan=plan), mttkrpn_plain(x, [a, b]))


def _chunked(x, fs, plan, sms=H100_SMS):
    """The kernel's walk in float32: per output tile and split (split s takes
    chunks s, s + S, ...), each chunk (leading tuple p, last-axis offset off) adds P_p * (X[:, p, off:off+bk]
    @ A_last[off:off+bk]) to the tile's accumulator; the splits' slabs are
    added in slab order."""
    shape, rank = tuple(x.shape), fs[0].shape[1]
    c_last = shape[-1]
    n_prefix = math.prod(shape[1:-1])
    cpp = math.ceil(c_last / plan.block_k)
    _, _, splits = mttkrp_kernel_grid(shape, rank, plan, sms)
    xv = x.reshape(shape[0], n_prefix, c_last)
    lead = fs[:-1]
    slabs = torch.zeros((splits, shape[0], rank))
    nch = n_prefix * cpp
    for s in range(splits):
        for ch in range(s, nch, splits):  # split s takes chunks s, s + S, ...
            pf, off = divmod(ch, cpp)
            off *= plan.block_k
            digits = np.unravel_index(pf, shape[1:-1]) if lead else ()
            pvec = torch.ones(rank)
            for f, dgt in zip(lead, digits):
                pvec = pvec * f[int(dgt)]
            part = xv[:, pf, off:off + plan.block_k] @ fs[-1][off:off + plan.block_k]
            slabs[s] += pvec * part
    return slabs.sum(0)


@pytest.mark.parametrize("dims,rank,plan,jplan", [
    ((11, 7, 9), 5, MTTKRPKernelPlan(64, 8, 16, 2), JPlan(4, (2, 4), 2)),
    ((6, 13, 10), 3, MTTKRPKernelPlan(64, 16, 16, 3), JPlan(8, (8, 8), 4)),
    ((5, 4, 3, 7), 4, MTTKRPKernelPlan(64, 8, 16, 2), JPlan(2, (3, 2, 4), 4)),
    ((9, 40), 6, MTTKRPKernelPlan(64, 16, 16, 2), JPlan(8, (8,), 8)),
])
def test_chunked_walk_matches_pallas(dims, rank, plan, jplan):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(dims, dtype=np.float32)
    fs = [rng.standard_normal((d, rank), dtype=np.float32) for d in dims[1:]]
    want = np.asarray(mttkrp_canonical_pallas(
        jnp.asarray(x), [jnp.asarray(f) for f in fs], plan=jplan, interpret=True,
        variant="generic"))
    got = _chunked(torch.from_numpy(x), [torch.from_numpy(f) for f in fs], plan).numpy()
    assert float(np.abs(got - want).max()) <= F32_TOL * float(np.abs(want).max())


def _cuda_ctx():
    return repro_torch.ExecutionContext.create(
        "cuda", device="cpu", memory=Memory.abstract(4096, itemsize=4))


def test_engine_does_not_plan_mttkrp_with_choose_blocks_on_cuda(monkeypatch):
    """On ``cuda`` the kernels plan themselves: ``ctx.memory`` no longer
    picks a reference-shaped plan for ``mttkrp``, for the no-rank edge of
    ``contract_partial``, or for its rank-augmented partial kernel (which
    takes a ``PartialKernelPlan`` from the node's strides). Every port
    module that holds ``choose_blocks`` is watched."""
    planned = []
    real = plan_mod.choose_blocks

    def spy(*a, **k):
        planned.append(k.get("x_has_rank"))
        return real(*a, **k)

    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").startswith("repro_torch")
                and getattr(mod, "choose_blocks", None) is real):
            monkeypatch.setattr(mod, "choose_blocks", spy)
    seen = []  # every cuda MTTKRP goes through kernels.ops.mttkrp_canonical
    real_canon = execute.kernel_ops.mttkrp_canonical
    monkeypatch.setattr(execute.kernel_ops, "mttkrp_canonical",
                        lambda *a, plan=None, **k: seen.append(plan) or real_canon(
                            *a, plan=plan, **k))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((6, 5, 4), dtype=np.float32))
    fs = [torch.from_numpy(rng.standard_normal((d, 3), dtype=np.float32)) for d in (6, 5, 4)]
    ctx = _cuda_ctx()
    einsum = repro_torch.ExecutionContext.create("einsum", device="cpu")
    for mode in range(3):
        got = repro_torch.mttkrp(x, fs, mode, ctx=ctx)
        want = repro_torch.mttkrp(x, fs, mode, ctx=einsum)
        assert float((got - want).abs().max()) <= F32_TOL * float(want.abs().max())
    edge = repro_torch.contract_partial(x, fs, (0, 1, 2), (0,), False, ctx=ctx)
    assert edge.shape == (5, 4, 3)
    assert planned == [] and seen == [None] * 4
    node = torch.from_numpy(rng.standard_normal((5, 4, 3), dtype=np.float32))
    repro_torch.contract_partial(node, fs, (1, 2), (2,), True, ctx=ctx)
    assert planned == []
