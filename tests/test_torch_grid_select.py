"""Pure parity of the port's distributed layer with the reference: grid
selection (every function of ``grid_select``), the ring schedule, the
mesh's validators and axis sets, the ``Distribution`` dicts, the distributed
context's round trip and refusals, and the roofline; all exact (the same
integers and the same floats), no processes.
"""

from __future__ import annotations

import math

import pytest

import repro
import repro_torch
from repro.distributed import grid_select as ref_gs
from repro.distributed import mesh as ref_mesh
from repro.distributed import ring as ref_ring
from repro.analysis import roofline as ref_roofline
from repro_torch.analysis import roofline
from repro_torch.distributed import grid_select as gs
from repro_torch.distributed import mesh
from repro_torch.distributed import ring
from repro_torch.engine.context import Distribution, ExecutionContext, check_driver_options

SHAPES = [(8, 12, 16), (30, 7, 64), (64, 64, 64), (12, 18, 8, 10), (6, 10, 4, 8, 12)]
RANKS = [1, 4, 12]
PROCS = range(1, 17)


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert (a.p0, tuple(a.grid), a.words, a.algorithm, a.objective) == \
        (b.p0, tuple(b.grid), b.words, b.algorithm, b.objective)


@pytest.mark.parametrize("dims", SHAPES, ids=lambda d: "x".join(map(str, d)))
def test_stationary_selection_equals_the_reference(dims):
    for rank in RANKS:
        for p in PROCS:
            for mode in (None, 0, len(dims) - 1):
                for div in (False, True):
                    _same(gs.select_stationary_grid(dims, rank, p, mode, div),
                          ref_gs.select_stationary_grid(dims, rank, p, mode, div))
            _same(gs.brute_force_stationary(dims, rank, p, None, True),
                  ref_gs.brute_force_stationary(dims, rank, p, None, True))
            _same(gs.choose_cp_grid(dims, rank, p), ref_gs.choose_cp_grid(dims, rank, p))


@pytest.mark.parametrize("dims", SHAPES, ids=lambda d: "x".join(map(str, d)))
def test_general_selection_equals_the_reference(dims):
    for rank in RANKS:
        for p in PROCS:
            for div in (False, True):
                _same(gs.select_general_grid(dims, rank, p, 0, div),
                      ref_gs.select_general_grid(dims, rank, p, 0, div))
                for algorithm in ("auto", "stationary", "general"):
                    try:
                        want = ref_gs.select_grid(dims, rank, p, algorithm, 0, div)
                    except ValueError as e:
                        with pytest.raises(ValueError, match="no feasible grid"):
                            gs.select_grid(dims, rank, p, algorithm, 0, div)
                        assert "no feasible grid" in str(e)
                        continue
                    _same(gs.select_grid(dims, rank, p, algorithm, 0, div), want)
            _same(gs.brute_force_general(dims, rank, p, 0, False),
                  ref_gs.brute_force_general(dims, rank, p, 0, False))


@pytest.mark.parametrize("dims", SHAPES, ids=lambda d: "x".join(map(str, d)))
def test_tucker_selection_and_sweep_words_equal_the_reference(dims):
    for ranks in ((2,) * len(dims), tuple(range(2, 2 + len(dims)))):
        for p in PROCS:
            for div in (False, True):
                _same(gs.select_tucker_grid(dims, ranks, p, div),
                      ref_gs.select_tucker_grid(dims, ranks, p, div))
            _same(gs.choose_tucker_grid(dims, ranks, p), ref_gs.choose_tucker_grid(dims, ranks, p))
            _same(gs.brute_force_tucker(dims, ranks, p, True),
                  ref_gs.brute_force_tucker(dims, ranks, p, True))
            grid = ref_gs.choose_tucker_grid(dims, ranks, p).grid
            assert gs.multi_ttm_sweep_words(dims, ranks, grid) == \
                ref_gs.multi_ttm_sweep_words(dims, ranks, grid)
    for rank in RANKS:
        for p in PROCS:
            grid = ref_gs.choose_cp_grid(dims, rank, p).grid
            for solve in (False, True):
                assert gs.stationary_sweep_words(dims, rank, grid, solve) == \
                    ref_gs.stationary_sweep_words(dims, rank, grid, solve)
            assert gs.stationary_mode_words(dims, rank, grid, 0) == \
                ref_gs.stationary_mode_words(dims, rank, grid, 0)
            assert gs.general_mode_words(dims, rank, grid, 1, 0) == \
                ref_gs.general_mode_words(dims, rank, grid, 1, 0)
            assert gs.shardable(dims, rank, grid) == ref_gs.shardable(dims, rank, grid)
            assert gs.tucker_shardable(dims, grid) == ref_gs.tucker_shardable(dims, grid)


def test_select_grid_refusals_equal_the_reference():
    for args in (((8, 8, 8), 4, 4, "bogus"), ((8, 8, 8), 4, 4, "general", None)):
        with pytest.raises(ValueError) as port:
            gs.select_grid(*args)
        with pytest.raises(ValueError) as ref:
            ref_gs.select_grid(*args)
        assert str(port.value) == str(ref.value)
    assert gs.GridChoice(2, (2, 3), 1.0, "general", "mode0").procs == 12


@pytest.mark.parametrize("q", range(1, 9))
def test_ring_schedule_equals_the_reference(q):
    assert ring.ring_perm(q) == ref_ring.ring_perm(q)
    for me in range(q):
        for t in range(q):
            assert ring.arrival_source(me, t, q) == ref_ring.arrival_source(me, t, q)
            assert ring.reduce_chunk_index(me, t, q) == ref_ring.reduce_chunk_index(me, t, q)


@pytest.mark.parametrize("args", [
    dict(grid=()), dict(grid=(2, 0)), dict(grid=(2, 2), p0=0),
    dict(grid=(2, 2), p0=3, rank=8), dict(grid=(2, 2), dims=(8, 8, 8)),
    dict(grid=(3, 1), dims=(8, 9)), dict(grid=(2, 3), dims=(8, 9)),
    dict(grid=(2, 1), p0=3, dims=(8, 12), rank=6), dict(grid=(2, 2), dims=(8, 8), rank=4),
])
def test_validate_grid_messages_equal_the_reference(args):
    args = {**args, "check_devices": False}
    try:
        ref_mesh.validate_grid(**args)
    except ValueError as e:
        with pytest.raises(ValueError) as port:
            mesh.validate_grid(**args)
        assert str(port.value) == str(e)
        return
    mesh.validate_grid(**args)


@pytest.mark.parametrize("args", [
    dict(grid=()), dict(grid=(1, -1)), dict(grid=(2, 2), dims=(4, 4, 4)),
    dict(grid=(3, 2), dims=(6, 5)), dict(grid=(3, 5), dims=(6, 5)),
])
def test_validate_tucker_grid_messages_equal_the_reference(args):
    args = {**args, "check_devices": False}
    try:
        ref_mesh.validate_tucker_grid(**args)
    except ValueError as e:
        with pytest.raises(ValueError) as port:
            mesh.validate_tucker_grid(**args)
        assert str(port.value) == str(e)
        return
    mesh.validate_tucker_grid(**args)


def test_validate_grid_counts_the_processes():
    with pytest.raises(RuntimeError, match="not initialized"):
        mesh.validate_grid((2, 2))


@pytest.mark.parametrize("ndim", [2, 3, 4, 5])
def test_axis_sets_equal_the_reference(ndim):
    assert mesh.RANK_AXIS == ref_mesh.RANK_AXIS
    for k in range(ndim):
        assert mesh.mode_axis(k) == ref_mesh.mode_axis(k)
        assert mesh.hyperslice_axes(ndim, k) == ref_mesh.hyperslice_axes(ndim, k)
        assert mesh.row_sharding_axes(ndim, k) == ref_mesh.row_sharding_axes(ndim, k)


@pytest.mark.parametrize("grid,p0", [((2, 2, 1), 1), ((1, 1, 2, 2), 1), ((2, 1, 1), 2),
                                     ((2, 3, 2), 2)])
def test_layout_is_the_reference_mesh_in_row_major_order(grid, p0):
    """A rank's coordinates are its row-major index over the axes, as
    ``jax.make_mesh`` lays devices; each axis set partitions the ranks and
    orders a group row-major over its axes."""
    layout = mesh.make_abstract_grid_mesh(grid, p0)
    abstract = ref_mesh.make_abstract_grid_mesh(grid, p0)
    assert layout.names == tuple(abstract.axis_names)
    assert layout.shape == tuple(abstract.axis_sizes)
    for r in range(layout.size):
        assert layout.rank_of(layout.coords(r)) == r
    for axes in layout.group_axes():
        groups = layout.partition(axes)
        assert sorted(r for g in groups for r in g) == list(range(layout.size))
        for g in groups:
            assert [layout.linear(r, axes) for r in g] == list(range(len(g)))


@pytest.mark.parametrize("kw", [
    {}, {"grid": (2, 2, 1)}, {"procs": 8, "check_rep": False}, {"grid": (2, 1), "p0": 2},
    {"overlap": "ring", "check_rep": True},
])
def test_distribution_dicts_equal_the_reference(kw):
    port = Distribution(**kw)
    ref = repro.Distribution(**kw)
    assert port.to_dict() == ref.to_dict()
    assert Distribution.from_dict(ref.to_dict()) == port
    assert repro.Distribution.from_dict(port.to_dict()) == ref


@pytest.mark.parametrize("kw", [{"overlap": "tree"}, {"procs": 0}, {"p0": 0},
                                {"grid": (2, 0)}])
def test_distribution_refusals_equal_the_reference(kw):
    with pytest.raises(ValueError) as ref:
        repro.Distribution(**kw)
    with pytest.raises(ValueError) as port:
        Distribution(**kw)
    if "overlap" not in kw:  # the overlap message names the port's ring
        assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("kw", [
    {"distributed": True}, {"grid": (2, 2, 1)}, {"procs": 4, "overlap": "ring"},
    {"grid": (2, 1, 1), "p0": 2, "check_rep": False},
])
def test_distributed_context_save_load_and_local(tmp_path, kw):
    ctx = ExecutionContext.create("einsum", device="cpu", **kw)
    assert ctx.is_distributed and ctx.distribution.to_dict() == \
        repro.ExecutionContext.create(**kw).distribution.to_dict()
    path = str(tmp_path / "ctx.json")
    ctx.save(path)
    again = ExecutionContext.load(path)
    assert again == ctx and again.distribution == ctx.distribution
    local = ctx.local()
    assert not local.is_distributed and local.backend == "einsum" and local.local() is local
    assert ExecutionContext.create("einsum", device="cpu").local().distribution is None


def test_distributed_context_resolves_the_grid():
    ctx = ExecutionContext.create("cuda", device="cpu", procs=4).resolve_for((8, 12, 16), 4)
    ref = repro.ExecutionContext.create(procs=4).resolve_for((8, 12, 16), 4)
    assert ctx.distribution.grid == ref.distribution.grid and ctx.decisions == ()
    tk = ExecutionContext.create("cuda", device="cpu", procs=4).resolve_for((8, 12, 16), (2, 2, 2))
    assert tk.distribution.grid == \
        repro.ExecutionContext.create(procs=4).resolve_for((8, 12, 16), (2, 2, 2)).distribution.grid
    assert mesh.make_abstract_grid_mesh(ctx.distribution.grid).size == 4
    with pytest.raises(ValueError, match="no grid resolved yet"):
        ExecutionContext.create("cuda", device="cpu", procs=4).build_mesh()
    with pytest.raises(ValueError, match="non-distributed context"):
        ExecutionContext.create("cuda", device="cpu").build_mesh()


def test_check_driver_options_errors_equal_the_reference():
    port = ExecutionContext.create("einsum", device="cpu", distributed=True)
    ref = repro.ExecutionContext.create(distributed=True)
    from repro.engine.context import check_driver_options as ref_check

    for kw in ({"mttkrp_fn": len}, {"use_dimension_tree": True}):
        with pytest.raises(ValueError) as a:
            check_driver_options(port, **kw)
        with pytest.raises(ValueError) as b:
            ref_check(ref, **kw)
        assert str(a.value) == str(b.value)
    check_driver_options(ExecutionContext.create("einsum", device="cpu"), mttkrp_fn=len)
    with pytest.raises(ValueError, match="tune=True is not supported on the distributed path"):
        ExecutionContext.create("auto", device="cpu", tune=True, distributed=True)


def test_public_surface_names_the_reference_entries():
    assert repro_torch.Distribution is Distribution
    assert repro_torch.select_grid((8, 8, 8), 4, 4) == gs.select_grid((8, 8, 8), 4, 4)
    assert repro_torch.select_tucker_grid((8, 8, 8), (2, 2, 2), 4) == \
        gs.select_tucker_grid((8, 8, 8), (2, 2, 2), 4)


@pytest.mark.parametrize("terms", [(1e12, 2e9, 3e7, 4e13, 8), (0.0, 1e6, 0.0, 0.0, 1),
                                   (5e14, 1e11, 1e10, 2e15, 4)])
def test_roofline_is_the_reference_formula(terms):
    hw = roofline.HW("tpu-v5e", {"bfloat16": ref_roofline.V5E.peak_flops},
                     ref_roofline.V5E.hbm_bw, ref_roofline.V5E.link_bw)
    got = roofline.roofline(*terms, hw=hw)
    want = ref_roofline.roofline(*terms, hw=ref_roofline.V5E)
    for f in ("t_compute", "t_memory", "t_collective", "useful_ratio", "bottleneck", "hw",
              "step_time", "step_time_overlapped", "mfu_bound"):
        assert getattr(got, f) == getattr(want, f), f


def test_h100_table_and_the_kernel_bounds():
    """The H100 peaks are the data sheet's, and the bound rule reads every
    main-path ``bound_ms`` of PERF.md section 6 as the card runs wrote it."""
    h = roofline.H100
    assert (h.peak_flops["float32"], h.peak_flops["tf32"], h.peak_flops["bfloat16"],
            h.hbm_bw, h.link_bw) == (67e12, 495e12, 989e12, 3.35e12, 50e9)
    n3, f3, n4 = 1000 ** 3, 2 * 1000 * 64, 180 ** 4
    rows = {
        # mttkrp3 1000^3 R=64, fp32 and bf16
        "mttkrp3": (roofline.mma_bound(n3, 4, f3, 1000 * 64, 2.0 * n3 * 64, "float32"), 1.194),
        "mttkrp3 bf16": (roofline.mma_bound(n3, 2, f3, 1000 * 64, 2.0 * n3 * 64, "bfloat16"),
                         0.597),
        # mttkrpn 180^4 R=32 mode 0
        "mttkrpn": (roofline.mma_bound(n4, 4, 3 * 180 * 32, 180 * 32, 2.0 * n4 * 32, "float32"),
                    1.253),
        # ssd_intra at BC=64, q=256, N=128, H=80, P=64: x bf16, then fp32
        "ssd_intra": (roofline.ssd_bound(64, 256, 128, 80, 64, 2), 0.108),
        "ssd_intra fp32": (roofline.ssd_bound(64, 256, 128, 80, 64, 4), 0.208),
    }
    for name, ((ms, by), want) in rows.items():
        assert round(ms, 3) == want and by == "bytes", name
    # the plain rule, split-K on the 1000^3 workspace: 33 slabs of 64,000
    ms, by = roofline.bound(64000 * 33, 4, 0, 64000, 32 * 64000, "float32")
    assert ms == (64000 * 33 * 4 + 64000 * 4) / 3.35e12 * 1e3 and by == "bytes"
    assert math.isclose(roofline.bound(1, 4, 0, 0, 67e12, "float32")[0], 1e3)
