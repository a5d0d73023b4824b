"""The streaming partial kernel's own plan and walk, on the CPU.

``choose_partial_kernel_blocks`` plans the rank-augmented partial kernel
from the node's shape and strides (the node is read in place): the layout
(which axis the warp spans beside the r-vectors), the rows a CTA, the
vector width, the loads in flight and the splits. Its shared-memory mirror
is the ``"contract"`` layout's cross-warp fold. The kernel's walk (units of
an outer contraction tuple and a chunk of the innermost axis, split over
CTAs, each thread's c steps in order, the fold across the lane axis's
threads by a shuffle butterfly and then warp by warp, the slabs added in
slab order) is emulated here in float32 and held against the reference's
Pallas kernel in interpret mode to 1e-5 of the largest output magnitude
(float32 on both sides, different summation orders). ``contract_partial``
on ``cuda`` hands the kernel the permuted view; its plain version takes
that view on the CPU, checked on every edge against the reference.
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.kernels.ops import mttkrp_partial_canonical_pallas
from repro_torch.convert import factors_from_numpy
from repro_torch.engine.plan import (
    CTAS_PER_SM,
    H100_SMS,
    PARTIAL_LOADS,
    PARTIAL_SMALL_NODE_BYTES,
    PARTIAL_THREAD_ROWS,
    PartialKernelPlan,
    choose_partial_kernel_blocks,
    partial_kernel_grid,
    partial_kernel_smem_bytes,
    partial_kernel_threads,
)
from repro_torch.kernels import ops
from repro_torch.kernels.partial import mttkrp_partial, mttkrp_partial_plain, node_view

from _torch_parity import close

F32_TOL = 1e-5


def _view(shape, perm, rank):
    """A contiguous node of axis sizes ``shape`` + (rank,) seen through
    ``perm`` (the rank axis stays last)."""
    node = torch.empty(tuple(shape) + (rank,), dtype=torch.float32)
    return node.permute(tuple(perm) + (len(shape),))


# (node shape without R, permute, rank, kept axes after the permute)
MAIN = [
    ((1000, 1000), (1, 0), 64, 1),          # fused 3-way mode 1, in place
    ((1000, 1000), (0, 1), 64, 1),          # dimtree 3-way leaf, canonical
    ((180, 180, 180), (1, 0, 2), 32, 1),    # fused 4-way mode 1, in place
    ((180, 180, 180), (2, 0, 1), 32, 1),    # fused 4-way mode 2, in place
    ((180, 180), (0, 1), 32, 1),            # dimtree 4-way leaves
    ((180, 180), (1, 0), 32, 1),
]
RAGGED = [((7, 5), (1, 0), 7, 1), ((33, 17, 9), (2, 0, 1), 13, 1), ((9, 11), (0, 1), 300, 1),
          ((300, 9), (1, 0), 1, 1), ((3, 4, 3, 2, 5), (2, 0, 3, 1, 4), 7, 2),
          ((5, 6, 7), (0, 1, 2), 64, 2), ((1, 40, 6), (0, 1, 2), 16, 1)]


def _plan_for(view, k, itemsize=4, sms=H100_SMS, aligned=True):
    nkeep = view.ndim - 1 - k
    ks, kst, cs, cst, _ = node_view(view, nkeep)
    plan = choose_partial_kernel_blocks((*ks, *cs), (*kst, *cst), view.shape[-1], itemsize, sms,
                                        nkeep=len(ks), aligned=aligned)
    return plan, (ks, kst, cs, cst)


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,perm,rank,nkeep", MAIN + RAGGED)
def test_default_plan_fills_the_card_and_reads_the_node_once(shape, perm, rank, nkeep,
                                                             itemsize):
    view = _view(shape, perm, rank)
    k = view.ndim - 1 - nkeep
    plan, (ks, kst, cs, cst) = _plan_for(view, k, itemsize)
    plan.check(rank, itemsize)
    tr, tl, rtiles = partial_kernel_threads(rank, plan.vec)
    blocks, rt, units = partial_kernel_grid((*ks, *cs), rank, plan, len(ks))
    assert rt == rtiles
    # every row, rank column and contraction index lies in exactly one
    # (row block, rank tile, unit): the node is read once
    assert blocks * plan.block_rows >= math.prod(ks) > (blocks - 1) * plan.block_rows
    assert rtiles * tr * plan.vec >= rank > (rtiles - 1) * tr * plan.vec
    rows = plan.rows_per_thread(rank)
    chunk = plan.loads // rows * (tl if plan.layout == "contract" else 1)
    assert units == math.prod(cs[:-1]) * math.ceil(cs[-1] / chunk)
    # no split is empty; a large node fills one wave of CTAS_PER_SM CTAs an
    # SM and never starts a second; a small one splits only to give every
    # SM a CTA
    ctas, wave = blocks * rtiles, CTAS_PER_SM * H100_SMS
    assert plan.splits <= units
    if math.prod((*ks, *cs)) * rank * itemsize > PARTIAL_SMALL_NODE_BYTES:
        assert ctas * plan.splits <= max(ctas, wave)
        assert plan.splits == units or ctas * (plan.splits + 1) > wave
    else:
        assert plan.layout == "contract"
        assert plan.splits == (1 if ctas >= H100_SMS else min(units, -(-H100_SMS // ctas)))
    assert rows in PARTIAL_THREAD_ROWS and rows * plan.vec <= 32
    assert plan.loads == max(PARTIAL_LOADS)
    # 16-byte loads wherever R and the strides allow them
    wide = 16 // itemsize
    assert plan.vec == (wide if rank % wide == 0 and all(s % wide == 0 for s in kst + cst)
                        else 1)


@pytest.mark.parametrize("shape,perm,rank,want", [
    ((1000, 1000), (1, 0), 64, "rows"),         # P(I0, I1, R) for mode 1: I1 next to r
    ((1000, 1000), (0, 1), 64, "contract"),     # canonical: the dropped axis next to r
    ((180, 180, 180), (2, 0, 1), 32, "rows"),   # mode 2's kept I2 next to r
    ((180, 180, 180), (1, 0, 2), 32, "contract"),
    ((180, 180, 180), (0, 2, 1), 32, "contract"),  # dropped axes out of stride order
    ((1, 50000), (0, 1), 64, "contract"),       # one row: nothing to span
    ((180, 180), (1, 0), 32, "contract"),       # 4 MB: planned to need no reduction
])
def test_layout_follows_the_strides(shape, perm, rank, want):
    view = _view(shape, perm, rank)
    plan, (_, _, _, cst) = _plan_for(view, len(shape) - 1)
    assert plan.layout == want
    assert list(cst) == sorted(cst, reverse=True)  # the innermost contraction axis last


def test_plans_are_cached_per_view():
    choose_partial_kernel_blocks.cache_clear()
    view = _view((180, 180), (1, 0), 32)
    a, _ = _plan_for(view, 1)
    b, _ = _plan_for(view, 1)
    assert a is b and choose_partial_kernel_blocks.cache_info().hits == 1
    c, _ = _plan_for(view, 1, sms=114)  # another card: planned anew
    assert choose_partial_kernel_blocks.cache_info().misses == 2 and c.layout == a.layout
    assert (a.block_rows, a.splits, c.splits) == (1, 1, 1)  # 180 row blocks, no split
    d, _ = _plan_for(view, 1, aligned=False)
    assert d.vec == 1


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("rank", [1, 7, 13, 32, 64, 300])
def test_smem_mirror_matches_the_plan(rank, itemsize):
    for layout, rows, vec, loads in itertools.product(
            ("rows", "contract"), PARTIAL_THREAD_ROWS, (1, 16 // itemsize), PARTIAL_LOADS):
        if rank % vec or loads < rows:
            continue
        tr, tl, _ = partial_kernel_threads(rank, vec)
        plan = PartialKernelPlan(layout, rows * (tl if layout == "rows" else 1), vec, loads, 3)
        plan.check(rank, itemsize)
        want = 0 if layout == "rows" else 4 * 8 * rows * tr * vec
        assert partial_kernel_smem_bytes(plan, rank) == want <= 232_448


@pytest.mark.parametrize("plan", [
    PartialKernelPlan("columns", 8, 4, 8, 1),    # no such layout
    PartialKernelPlan("contract", 3, 4, 8, 1),   # 3 rows a thread
    PartialKernelPlan("rows", 24, 4, 8, 1),      # not a multiple of the lane threads
    PartialKernelPlan("contract", 8, 2, 8, 1),   # 8-byte loads
    PartialKernelPlan("contract", 8, 4, 4, 1),   # fewer loads than rows
    PartialKernelPlan("contract", 4, 4, 8, 0),   # no split
])
def test_plans_the_kernel_does_not_take_raise(plan):
    with pytest.raises(ValueError):
        plan.check(32, 4)


def test_node_view_merges_kept_axes_and_orders_the_contraction():
    x = torch.empty((3, 4, 5, 6, 2))
    ks, kst, cs, cst, order = node_view(x.permute(0, 1, 3, 2, 4), 2)
    assert (ks, kst) == ([12], [60]) and (cs, cst, order) == ([5, 6], [12, 2], [1, 0])
    ks, kst, *_ = node_view(x.permute(1, 0, 2, 3, 4), 2)  # do not merge
    assert (ks, kst) == ([4, 3], [60, 240])
    ks, kst, *_ = node_view(x[:1].permute(0, 2, 1, 3, 4), 1)  # a size-1 kept axis
    assert (ks, kst) == ([1], [0])


def _walk(view, fs, plan):
    """The kernel's walk in float32: split s takes units [s U / S, (s+1) U / S)
    of (outer tuple o, chunk ch of C_k); per unit a thread takes its c steps
    in order (``"rows"``: c = ch * unroll + m, every row of its own;
    ``"contract"``: c = ch * TL * unroll + tl + m TL, lane thread tl, partial
    sums per tl), the weight ``A_k(c) * prod_d A_d(o_d)``; ``"contract"``
    folds the lane threads as the kernel does (a shuffle butterfly over the
    lanes of a warp, then warp by warp from 0); the slabs are added in slab
    order."""
    rank, k = view.shape[-1], len(fs)
    nkeep = view.ndim - 1 - k
    ks, kst, cs, cst, order = node_view(view, nkeep)
    fs = [fs[d].float() for d in order]
    tr, tl, _ = partial_kernel_threads(rank, plan.vec)
    unroll = plan.loads // plan.rows_per_thread(rank)
    rows = math.prod(ks)
    # the node as (rows, outer, C_k, R) through its strides
    flat = torch.as_strided(view, (view.untyped_storage().nbytes() // view.element_size(),),
                            (1,), 0).float()
    idx = torch.arange(rows)
    rix = torch.zeros(rows, dtype=torch.long)
    for d in range(len(ks) - 1, -1, -1):
        rix += idx % ks[d] * kst[d]
        idx = idx // ks[d]
    outer = math.prod(cs[:-1])
    oix, wo = torch.zeros(outer, dtype=torch.long), torch.ones((outer, rank))
    idx = torch.arange(outer)
    for d in range(k - 2, -1, -1):
        cd = idx % cs[d]
        oix += cd * cst[d]
        wo = wo * fs[d][cd]
        idx = idx // cs[d]
    cin = cs[-1]
    x = flat[view.storage_offset() + rix[:, None, None, None] + oix[None, :, None, None]
             + (torch.arange(cin) * cst[-1])[None, None, :, None]
             + torch.arange(rank)[None, None, None, :]]
    w = fs[-1][None] * wo[:, None]  # (outer, C_k, R): A_k(c) * wo(o)
    chunk = unroll * (tl if plan.layout == "contract" else 1)
    nch = math.ceil(cin / chunk)
    units = outer * nch
    lanes = 1 if plan.layout == "rows" else tl
    slabs = []
    for s in range(plan.splits):
        acc = torch.zeros((lanes, rows, rank))
        for u in range(s * units // plan.splits, (s + 1) * units // plan.splits):
            o, ch = divmod(u, nch)
            for m in range(unroll):
                c = ch * chunk + m * (tl if plan.layout == "contract" else 1) + torch.arange(lanes)
                ok = c < cin
                c = c.clamp(max=cin - 1)
                xv = x[:, o, c, :].permute(1, 0, 2) * ok[:, None, None]
                acc = acc + xv * w[o, c][:, None, :]
        if plan.layout == "contract":
            lw = 32 // tr  # lane threads in a warp
            acc = acc.reshape(tl // lw, lw, rows, rank)
            off = 1
            while off < lw:
                acc = acc + acc[:, torch.arange(lw) ^ off]
                off *= 2
            total = torch.zeros((rows, rank))
            for wp in range(tl // lw):
                total = total + acc[wp, 0]
            acc = total[None]
        slabs.append(acc[0])
    out = slabs[0]
    for slab in slabs[1:]:
        out = out + slab
    return out


# (node shape without R, permute, rank, kept axes, plan): both layouts,
# k = 1, 2, 3, ragged rows, C_k and R, splits that cut the C_k runs
WALKS = [
    ((13, 37), (0, 1), 32, 1, PartialKernelPlan("contract", 8, 4, 8, 3)),
    ((45, 19), (1, 0), 32, 1, PartialKernelPlan("rows", 64, 4, 8, 4)),
    ((5, 40, 6), (1, 0, 2), 32, 1, PartialKernelPlan("contract", 4, 4, 8, 7)),
    ((5, 6, 40), (2, 0, 1), 32, 1, PartialKernelPlan("rows", 32, 4, 4, 5)),
    ((3, 4, 3, 2, 5), (2, 0, 3, 1, 4), 7, 2, PartialKernelPlan("contract", 2, 1, 4, 2)),
    ((3, 4, 3, 2, 5), (2, 0, 3, 1, 4), 7, 2, PartialKernelPlan("rows", 32, 1, 2, 3)),
    ((9, 11), (0, 1), 300, 1, PartialKernelPlan("contract", 2, 4, 8, 2)),
    ((300, 9), (1, 0), 1, 1, PartialKernelPlan("rows", 512, 1, 8, 3)),
    ((4, 3, 5, 2), (0, 1, 2, 3), 5, 1, PartialKernelPlan("contract", 4, 1, 8, 4)),
]


@pytest.mark.parametrize("shape,perm,rank,nkeep,plan", WALKS)
def test_kernel_walk_matches_pallas(shape, perm, rank, nkeep, plan):
    rng = np.random.default_rng(11)
    base = rng.standard_normal(tuple(shape) + (rank,), dtype=np.float32)
    view = torch.from_numpy(base).permute(tuple(perm) + (len(shape),))
    k = len(shape) - nkeep
    fs = [rng.standard_normal((c, rank), dtype=np.float32) for c in view.shape[nkeep:-1]]
    canon = view.reshape((-1,) + tuple(view.shape[nkeep:]))
    want = np.asarray(mttkrp_partial_canonical_pallas(
        jnp.asarray(canon.numpy()), [jnp.asarray(f) for f in fs], interpret=True))
    got = _walk(view, [torch.from_numpy(f) for f in fs], plan).numpy()
    assert got.shape == want.shape and len(fs) == k
    assert float(np.abs(got - want).max()) <= F32_TOL * float(np.abs(want).max())
    # the plain version of the view, which a CPU tensor takes, agrees too
    close(mttkrp_partial(view, [torch.from_numpy(f) for f in fs], plan=plan), want)


def test_plain_version_reads_several_kept_axes():
    rng = np.random.default_rng(12)
    node = rng.standard_normal((3, 4, 5, 6, 2), dtype=np.float32)
    fs = [rng.standard_normal((c, 2), dtype=np.float32) for c in (5, 6)]
    view = torch.from_numpy(node).permute(1, 0, 2, 3, 4)  # kept axes that do not merge
    got = mttkrp_partial_plain(view, [torch.from_numpy(f) for f in fs])
    want = np.einsum("abcdz,cz,dz->baz", node, *fs).reshape(12, 2)
    close(got, want)
    close(ops.mttkrp_partial_canonical(view, [torch.from_numpy(f) for f in fs]), want)


def _edges(n):
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
    half = max(1, n // 2)
    for child in (full[:half], full[half:]):
        rec(child)
    inner = tuple(range(n - 1))
    out += [(inner, tuple(d for d in inner if d != m)) for m in range(n - 1)]
    out.append((inner, tuple(range(1, n - 1))))
    return out


@pytest.mark.parametrize("dims", [(7, 6, 5), (5, 4, 3, 6), (4, 3, 5, 2, 3)],
                         ids=["3way", "4way", "5way"])
def test_contract_partial_hands_a_permuted_view_on_every_edge(dims, monkeypatch):
    """On ``cuda`` (here with CPU tensors) every rank-carrying edge reaches
    the partial kernel's wrapper as a view of the node, not a copy, and
    agrees with the reference's Pallas path in interpret mode, also when
    the node itself is a non-contiguous view."""
    rank = 3
    rng = np.random.default_rng(13)
    fs = [rng.standard_normal((d, rank), dtype=np.float32) for d in dims]
    jctx = repro.ExecutionContext.create(backend="pallas", interpret=True)
    tctx = repro_torch.ExecutionContext.create("cuda", device="cpu")
    seen = []
    real = ops.mttkrp_partial
    monkeypatch.setattr(ops, "mttkrp_partial", lambda node, fs, **kw: seen.append(node)
                        or real(node, fs, **kw))
    for modes, drop in _edges(len(dims)):
        shape = tuple(dims[m] for m in modes) + (rank,)
        # the node as a non-contiguous view: a slice of a wider array
        wide = rng.standard_normal(shape[:-1] + (rank + 2,), dtype=np.float32)
        node = torch.from_numpy(wide)[..., 1:rank + 1]
        want = repro.contract_partial(jnp.asarray(node.numpy()), [jnp.asarray(f) for f in fs],
                                      modes, drop, True, ctx=jctx)
        seen.clear()
        got = repro_torch.contract_partial(node, factors_from_numpy(fs, "cpu"), modes, drop,
                                           True, ctx=tctx)
        close(got, want)
        assert len(seen) == 1 and seen[0].untyped_storage().data_ptr() == \
            node.untyped_storage().data_ptr()
