"""The kernel-coverage analyzer (``repro_torch.verify.kernels``) on the CPU.

Each Hopper kernel's walk in Python (the boxes every CTA stores) is proven
over the lattice: every element of every buffer written exactly once,
inside its buffer, under a grid within the launch limits, in the policy's
dtype. Here: the lattice is clean and launches nothing; it holds the
reference's five cases (``repro.verify.kernels.kernel_cases``) at their
shapes and the port's cells; the walks union to the tiles the CPU
emulations of the kernels write (``tests/test_torch_mttkrp_kernel_plan.py``,
``test_torch_partial_plan.py``, ``test_torch_ring_plans.py``,
``test_torch_ssd.py``: each writes whole slabs a split, P a tuple, rows a
tile); the counting agrees with element-by-element counting; and every
rule fires on a walk built to break it.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.engine import plan as tp
from repro_torch.engine.plan import MTTKRPKernelPlan, MultiTTMKernelPlan, PartialKernelPlan
from repro_torch.kernels import mttkrp3 as mttkrp3_mod
from repro_torch.kernels import ssd_intra as ssd_mod
from repro_torch.kernels.partial import node_view
from repro_torch.verify import Finding
from repro_torch.verify import kernels as vk


@pytest.fixture(scope="module")
def verified():
    before = vk.wrapper_launches()
    findings, verdicts = vk.verify_kernels()
    return findings, verdicts, before, vk.wrapper_launches()


def test_verify_kernels_is_clean_and_launches_nothing(verified):
    findings, verdicts, before, after = verified
    assert findings == []
    assert before == after
    assert len(verdicts) == len(vk.kernel_cases())
    for v in verdicts:
        assert v["agrees"] and v["findings"] == 0 and v["max_count"] == 1
        assert v["writes_checked"] == sum(math.prod(b["shape"]) for b in v["buffers"])
        assert set(v) >= {"name", "shape", "rank", "itemsize", "batch", "plan", "grid", "splits",
                          "buffers", "smem_bytes", "writes_checked", "agrees", "findings"}


def test_every_wrapper_is_in_the_lattice(verified):
    assert {v["name"] for v in verified[1]} == set(vk.WRAPPERS)


def _elements(walk, name):
    """Element-level write counts of one buffer of a walk (small shapes)."""
    buf = next(b for b in walk.buffers if b.name == name)
    counts = np.zeros(buf.shape, dtype=np.int64)
    for box in walk.boxes[name]:
        counts[tuple(slice(int(a), int(b)) for a, b in box)] += 1
    return counts


def test_the_reference_cases_are_covered_at_their_shapes():
    from repro.verify.kernels import kernel_cases as ref_cases

    ref = {c["name"]: tuple(int(d) for d in c["args"][0].shape) for c in ref_cases()}
    port = {c.wrapper: c for c in vk.kernel_cases() if c.label == "reference"}
    names = {"mttkrp3": "mttkrp3", "mttkrpn": "mttkrpn", "mttkrp_partial": "mttkrp_partial",
             "multi_ttm": "multi_ttm_keep", "fused_pair": "fused_pair"}
    for ref_name, shape in ref.items():
        case = port[names[ref_name]]
        assert case.itemsize == 2  # the reference's cases are bf16
        got = case.shape + (case.rank,) if ref_name == "mttkrp_partial" else case.shape
        assert got == shape, ref_name
    assert "ssd_intra" in port
    # multi-block grids, as the reference pins them
    for case in port.values():
        assert math.prod(vk.case_walk(case).grid) > 1, case


def test_the_port_cells_are_covered():
    cells = {(c.wrapper, c.shape, c.itemsize) for c in vk.kernel_cases()}
    for want in [("mttkrp3", (1000, 1000, 1000), 4), ("mttkrp3", (1000, 1000, 1000), 2),
                 ("mttkrpn", (180, 180, 180, 180), 4), ("fused_pair", (1000, 1000, 1000), 4),
                 ("mttkrp_partial", (1000, 1000), 4), ("mttkrp_partial", (180, 180, 180), 4),
                 ("multi_ttm_keep", (1000, 1000, 1000), 4),
                 ("ssd_intra", (64, 256, 128, 80, 64), 2), ("mttkrpn", (10000, 10000), 4)]:
        assert want in cells, want
    batches = {(c.wrapper, c.batch, c.shared) for c in vk.kernel_cases() if c.batch > 1}
    for w in ("mttkrp3", "multi_ttm_keep"):
        assert {(w, 16, False), (w, 16, True), (w, 65535, False)} <= batches
    assert ("mttkrp_partial", 65535, False) in batches
    # the partial kernel's both layouts, split and unsplit MTTKRP
    plans = [vk.case_plan(c) for c in vk.kernel_cases() if c.wrapper == "mttkrp_partial"]
    assert {p.layout for p in plans} == {"rows", "contract"}
    splits = {vk.case_walk(c).grid[1] for c in vk.kernel_cases() if c.wrapper == "mttkrp3"}
    assert 1 in splits and max(splits) > 1


# --------------------------------------------------------------------------
# the walks against the CPU emulations' tiles
# --------------------------------------------------------------------------

# test_torch_mttkrp_kernel_plan.py: _chunked writes slab s of (S, I, R) whole for every split
@pytest.mark.parametrize("dims,rank,plan", [
    ((11, 7, 9), 5, MTTKRPKernelPlan(64, 8, 16, 2)),
    ((6, 13, 10), 3, MTTKRPKernelPlan(64, 16, 16, 3)),
    ((5, 4, 3, 7), 4, MTTKRPKernelPlan(64, 8, 16, 2)),
    ((9, 40), 6, MTTKRPKernelPlan(64, 16, 16, 2)),
])
def test_mttkrp_walk_writes_the_emulations_slabs(dims, rank, plan):
    splits = tp.mttkrp_kernel_grid(dims, rank, plan, tp.H100_SMS)[2]
    walk = vk.mttkrp_walk(dims, rank, plan)
    counts = _elements(walk, walk.buffers[0].name)
    assert counts.shape == (splits, 1, dims[0], rank)
    assert (counts == 1).all()


# test_torch_partial_plan.py: _walk writes slab s of (S, rows, R) whole for every split
PARTIAL_WALKS = [
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


@pytest.mark.parametrize("shape,perm,rank,nkeep,plan", PARTIAL_WALKS)
def test_partial_walk_writes_the_emulations_slabs(shape, perm, rank, nkeep, plan):
    view = torch.zeros(tuple(shape) + (rank,)).permute(tuple(perm) + (len(shape),))
    ks, _, cs, _, _ = node_view(view, nkeep)
    walk = vk.partial_walk((*ks, *cs), rank, plan, len(ks))
    counts = _elements(walk, walk.buffers[0].name)
    assert counts.shape == (plan.splits, 1, math.prod(ks), rank)
    assert (counts == 1).all()


# test_torch_ring_plans.py: _pair_walk writes B0's slabs whole and P[:, pf] for every tuple
@pytest.mark.parametrize("dims,rank,plan", [
    ((11, 7, 9), 5, MTTKRPKernelPlan(64, 8, 16, 2)),
    ((6, 13, 10), 3, MTTKRPKernelPlan(64, 16, 16, 3)),
    ((5, 4, 3, 7), 4, MTTKRPKernelPlan(64, 8, 16, 2)),
    ((70, 9, 20), 6, MTTKRPKernelPlan(64, 8, 16, 2)),
])
def test_pair_walk_writes_the_emulations_tiles(dims, rank, plan):
    splits = tp.pair_kernel_grid(dims, rank, plan, tp.H100_SMS)[2]
    walk = vk.pair_walk(dims, rank, plan)
    b0 = _elements(walk, walk.buffers[0].name)
    p = _elements(walk, "p")
    assert b0.shape == (splits, dims[0], rank) and (b0 == 1).all()
    assert p.shape == (dims[0], math.prod(dims[1:-1]), rank) and (p == 1).all()
    # P's tuple pf comes from split pf % S, as _pair_walk takes pf = s, s + S, ...
    assert (walk.ctas["p"][:, 1] == walk.boxes["p"][:, 1, 0] % splits).all()


# test_torch_ring_plans.py: _ttm_walk writes row tiles (k = 1) or out[s, i] whole (k >= 2)
@pytest.mark.parametrize("dims,ranks,plan", [
    ((16, 8, 128), (4, 3), MultiTTMKernelPlan(64, 32, 16, 2)),
    ((8, 4, 6, 16), (2, 3, 2), MultiTTMKernelPlan(64, 8, 16, 2)),
    ((4, 3, 70, 24), (2, 3, 5), MultiTTMKernelPlan(64, 8, 16, 3)),
    ((3, 2, 150, 20), (2, 3, 4), MultiTTMKernelPlan(192, 8, 16, 2)),
    ((24, 16), (5,), MultiTTMKernelPlan(64, 8, 16, 2)),
])
def test_multi_ttm_walk_writes_the_emulations_tiles(dims, ranks, plan):
    splits = tp.multi_ttm_kernel_grid(dims, ranks, plan, tp.H100_SMS)[2]
    walk = vk.multi_ttm_walk(dims, ranks, plan)
    counts = _elements(walk, walk.buffers[0].name)
    assert counts.size == splits * dims[0] * math.prod(ranks) and (counts == 1).all()


# test_torch_ssd.py: _kernel_walk writes out[:, i0:i1] (every head, every column) a row tile
@pytest.mark.parametrize("shape,tile,heads", [((2, 40, 20, 4, 24), 16, 2), ((1, 70, 33, 3, 6), 32, 3),
                                              ((2, 16, 32, 2, 64), 64, 1)])
def test_ssd_walk_writes_the_emulations_tiles_longest_first(shape, tile, heads):
    bcn, q, _, h, p = shape
    walk = vk.ssd_walk(bcn, q, h, p, ssd_mod.SsdPlan(tile, heads))
    counts = _elements(walk, "out")
    assert counts.shape == (bcn, q, h, p) and (counts == 1).all()
    n_it, per_it = -(-q // tile), bcn * (h // heads)
    rows = walk.boxes["out"][:, 1]
    # blockIdx.x from 0 takes the last row tile (the longest CTAs) first
    assert (rows[:per_it, 0] == (n_it - 1) * tile).all()
    assert (np.diff(rows[:, 0]) <= 0).all()
    assert walk.grid == tp.ssd_intra_kernel_grid(bcn, q, h, tile, heads)


def test_ssd_grid_mirror_sizes_the_plan():
    # kernel_plan picks the most heads a CTA that still give every SM a CTA
    plan = ssd_mod.kernel_plan(256, 80, 64, 2, bcn=64)
    assert tp.ssd_intra_kernel_grid(64, 256, 80, plan.tile, plan.heads)[0] >= tp.H100_SMS
    with pytest.raises(ValueError, match="divide"):
        tp.ssd_intra_kernel_grid(2, 16, 6, 16, 4)


def test_splitk_walk_covers_every_grid_stride():
    for n in (1, 255, 256, 257, 64000, 132 * 32 * 256 + 7, 33 * 64000):
        walk = vk.splitk_walk(n)
        assert walk.grid[0] == min(-(-n // 256), 132 * 32)
        _, counts, elems = vk.count_writes((n,), walk.boxes["out"])
        assert (counts == 1).all() and elems.sum() == n


def test_count_writes_equals_element_counting():
    rng = np.random.default_rng(3)
    shape = (5, 7, 6)
    lo = rng.integers(0, np.array(shape), size=(40, 3))
    hi = lo + 1 + rng.integers(0, np.array(shape) - lo)
    boxes = np.stack([lo, hi], axis=2)
    cuts, counts, elems = vk.count_writes(shape, boxes)
    want = np.zeros(shape, dtype=np.int64)
    for box in boxes:
        want[tuple(slice(a, b) for a, b in box)] += 1
    got = np.zeros(shape, dtype=np.int64)
    for idx in np.ndindex(counts.shape):
        sl = tuple(slice(cuts[a][i], cuts[a][i + 1]) for a, i in enumerate(idx))
        got[sl] = counts[idx]
    assert (got == want).all() and elems.sum() == math.prod(shape)


# --------------------------------------------------------------------------
# every rule fires on a walk built to break it
# --------------------------------------------------------------------------

CASE = vk.WalkCase("mttkrp3", (200, 30, 40), 20, 4)


def _rules(walk, **kw):
    return {f.rule for f in vk.check_walk(walk, "seeded", **kw)[0]}


def _mttkrp():
    return vk.case_walk(CASE)


def test_the_seed_walk_is_clean():
    walk = _mttkrp()
    assert walk.grid[1] > 1 and walk.grid[0] > 1  # splits and several tiles
    assert _rules(walk) == set()


def test_a_dropped_cta_is_a_coverage_gap():
    walk = _mttkrp()
    keep = ~(walk.ctas["ws"] == 0).all(axis=1)
    walk.boxes["ws"], walk.ctas["ws"] = walk.boxes["ws"][keep], walk.ctas["ws"][keep]
    assert _rules(walk) == {"coverage-gap"}


def test_a_split_taking_another_splits_range_is_written_twice():
    walk = _mttkrp()
    boxes = walk.boxes["ws"].copy()
    one = boxes[:, 0, 0] == 1
    boxes[one, 0] = (0, 1)  # split 1 writes split 0's slab
    walk.boxes["ws"] = boxes
    assert _rules(walk) == {"write-once", "coverage-gap"}


def test_a_ragged_tile_written_past_the_edge_is_out_of_bounds():
    walk = _mttkrp()
    boxes = walk.boxes["ws"].copy()
    boxes[:, 2, 1] = boxes[:, 2, 0] + 128  # the row tile without its gi < I mask
    walk.boxes["ws"] = boxes
    found = vk.check_walk(walk, "seeded")[0]
    assert {f.rule for f in found} == {"oob-origin"}
    assert "outside the (" in found[0].detail


def test_a_batch_beyond_gridDim_z_breaks_the_grid():
    walk = vk.mttkrp_walk((8, 4, 4), 4, MTTKRPKernelPlan(64, 8, 16, 4), batch=65536)
    assert walk.grid[2] == 65536
    assert _rules(walk) == {"grid"}


def test_a_bf16_workspace_breaks_the_accumulator_dtype():
    walk = _mttkrp()
    walk.buffers = (vk.Buffer("ws", walk.buffers[0].shape, "bfloat16"),)
    assert _rules(walk) == {"acc-dtype"}
    # ssd_intra writes X's dtype: bf16 is its policy, float32 is not
    ssd = vk.ssd_walk(2, 40, 4, 24, ssd_mod.SsdPlan(16, 2), itemsize=2)
    assert _rules(ssd, expect_dtype="bfloat16") == set()
    assert _rules(ssd) == {"acc-dtype"}


def test_shared_memory_beyond_a_cta_breaks_the_footprint():
    assert _rules(_mttkrp(), smem=tp.SMEM_PER_CTA_MAX + 1) == {"footprint"}


def test_a_launch_during_the_analysis_is_a_finding(monkeypatch):
    real = vk.check_case

    def launching(case, *a, **kw):  # a launch count moving (restored after the test)
        monkeypatch.setattr(mttkrp3_mod.mttkrp3, "launches", mttkrp3_mod.mttkrp3.launches + 1)
        return real(case, *a, **kw)

    monkeypatch.setattr(vk, "check_case", launching)
    findings, _ = vk.verify_kernels([CASE])
    assert [f.rule for f in findings] == ["kernel-executed"]
    assert isinstance(findings[0], Finding) and findings[0].analyzer == "kernels"
