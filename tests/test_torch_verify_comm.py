"""The communication verifier (``repro_torch.verify.comm``) against the
reference's.

Every rank's program of each lattice point runs in this process on the
abstract transport (groups that move nothing, ``collectives.ABSTRACT``),
and each rank's counted bytes equal the reference's byte models exactly:
``cp_sweep_model_bytes``, ``tucker_sweep_model_bytes``,
``mttkrp_model_bytes``, with the bound from ``parallel_lb_bytes`` (plain
arithmetic, which runs on this jax; the reference's traced sweeps stop at
``shard_map``'s ``check_vma`` here, so its sweep bytes come from its
models). The ``MTTKRP_CASES`` verdicts equal the reference's traced
verdicts field by field; the ring-schedule and grid-selection families
give the reference's findings; and every rule fires on a seeded fault (the
reference's ``tests/test_verify.py`` fixtures).
"""

import types

import pytest
import torch

import repro.verify.comm as ref
import repro_torch.verify.comm as comm
from repro_torch.distributed import collectives
from repro_torch.distributed.collectives import ABSTRACT, COUNTER, Group, ring_total
from repro_torch.distributed.mesh import abstract_grid_mesh, make_abstract_grid_mesh
from repro_torch.kernels import mttkrp3 as mttkrp3_mod


def _rules(findings):
    return {f.rule for f in findings}


@pytest.mark.parametrize("dims,rank,grid", comm.CP_CASES)
@pytest.mark.parametrize("overlap", comm.OVERLAPS)
def test_cp_sweep_bytes_equal_the_reference_model(dims, rank, grid, overlap):
    findings, v = comm.check_cp_sweep(dims, rank, grid, overlap)
    assert findings == [] and v["agrees"] and v["transport"] == "abstract"
    assert v["measured_collective_bytes"] == ref.cp_sweep_model_bytes(dims, rank, grid)
    assert v["lower_bound_words"] * 4 == ref.parallel_lb_bytes(dims, rank, v["procs"])
    if overlap == "ring":
        assert set(v["collectives"]) <= {"all-reduce", "collective-permute"}


@pytest.mark.parametrize("dims,ranks,grid", comm.TUCKER_CASES)
@pytest.mark.parametrize("overlap", comm.OVERLAPS)
def test_tucker_sweep_bytes_equal_the_reference_model(dims, ranks, grid, overlap):
    findings, v = comm.check_tucker_sweep(dims, ranks, grid, overlap)
    assert findings == [] and v["agrees"]
    assert v["measured_collective_bytes"] == ref.tucker_sweep_model_bytes(dims, ranks, grid)


@pytest.mark.parametrize("dims,rank,grid,mode", comm.MTTKRP_CASES)
def test_mttkrp_stationary_verdict_equals_the_reference(dims, rank, grid, mode):
    findings, v = comm.check_mttkrp_stationary(dims, rank, grid, mode)
    ref_findings, ref_v = ref.check_mttkrp_stationary(dims, rank, grid, mode)
    assert findings == [] and ref_findings == []
    assert {k: v[k] for k in ref_v} == ref_v
    assert v["measured_collective_bytes"] == ref.mttkrp_model_bytes(dims, rank, grid, mode)


def test_every_rank_counts_the_same_bytes():
    def program(mesh):
        from repro_torch.distributed.cp_als_parallel import build_cp_sweep, place_cp_state
        from repro_torch.engine.context import ExecutionContext

        ctx = ExecutionContext.create("einsum", device="cpu", grid=(2, 2, 2))
        x, fs = comm._operands((8, 8, 8), (4, 4, 4))
        build_cp_sweep(mesh, 3, ctx=ctx)(*place_cp_state(mesh, x, fs), torch.tensor(1.0))

    counted = [ring_total(d) for d in comm.count_ranks((2, 2, 2), program)]
    assert len(counted) == 8 and set(counted) == {ref.cp_sweep_model_bytes((8, 8, 8), 4,
                                                                           (2, 2, 2))}


def test_the_abstract_transport_returns_shapes_and_counts_ring_bytes():
    group = Group((0, 1, 2, 3), 1, None, ABSTRACT)
    x = torch.arange(6.0).reshape(3, 2)
    before = COUNTER.snapshot()
    assert collectives.all_gather(x, group).shape == (12, 2)
    assert torch.equal(collectives.all_reduce(x, group), 4 * x)
    c = torch.arange(8.0).reshape(4, 2)
    assert torch.equal(collectives.reduce_scatter(c, group), 4 * c[1:2])
    assert torch.equal(collectives.permute(x, group), x)
    delta = COUNTER.delta(before)
    nb = 24  # x's bytes
    assert {k: d["ring_bytes"] for k, d in delta.items()} == {
        "all-gather": 3 * nb, "all-reduce": int(2 * 3 / 4 * nb), "reduce-scatter": 3 * 8,
        "collective-permute": nb}


def test_the_abstract_mesh_is_the_layouts_groups():
    layout = make_abstract_grid_mesh((2, 2, 2))
    for r in range(8):
        mesh = abstract_grid_mesh(layout, r)
        assert mesh.device.type == "cpu" and mesh.backend == ABSTRACT
        for axes, g in mesh.groups.items():
            assert g.ranks == layout.ranks_along(r, axes) and g.ranks[g.me] == r
            assert g.pg is None and g.backend == ABSTRACT
    with pytest.raises(ValueError, match="outside"):
        abstract_grid_mesh(layout, 8)


# --------------------------------------------------------------------------
# the ring schedules and grid selection: the reference's findings
# --------------------------------------------------------------------------

def _keys(findings):
    return [(f.analyzer, f.rule, f.subject) for f in findings]


def _dicts(findings):
    return [f.to_dict() for f in findings]


@pytest.mark.parametrize("q", comm.RING_SIZES)
def test_ring_schedules_are_clean_as_the_reference(q):
    assert comm.check_ring_schedules(q) == [] == ref.check_ring_schedules(q)
    assert comm.simulate_ring_arrivals(q) == ref.simulate_ring_arrivals(q)


@pytest.mark.parametrize("perm", [[(i, (i + 2) % 4) for i in range(4)],
                                  [(0, 1), (1, 1), (2, 3), (3, 0)]])
def test_two_cycle_permutation_is_a_deadlock(perm):
    found = comm.check_ring_permutation(perm, 4, "fixture")
    assert _rules(found) == {"ring-deadlock"}
    assert _keys(found) == _keys(ref.check_ring_permutation(perm, 4, "fixture"))


def test_off_by_one_consumer_is_flagged():
    def early(me, t, q):
        return (me - t - 1) % q

    found = comm.check_consumer_schedule(4, "fixture", source_fn=early)
    assert "read-before-arrival" in _rules(found)
    assert _dicts(found) == _dicts(ref.check_consumer_schedule(4, "fixture", source_fn=early))


def test_wrong_reduce_scatter_schedule_is_flagged():
    def flipped(me, t, q):
        return (me + t + 1) % q

    found = comm.check_reduce_scatter_schedule(4, "fixture", chunk_fn=flipped)
    assert "ring-reduction-coverage" in _rules(found)
    assert _dicts(found) == _dicts(ref.check_reduce_scatter_schedule(4, "fixture",
                                                                      chunk_fn=flipped))


def test_assembly_flags_a_misplaced_arrival(monkeypatch):
    import repro_torch.distributed.ring as ring

    monkeypatch.setattr(ring, "arrival_source", lambda me, t, q: t % q)
    assert _rules(comm.check_assembly(4, "fixture")) == {"ring-assembly"}


@pytest.mark.parametrize("dims,rank,procs", comm.GRID_SELECT_CASES)
def test_grid_selection_matches_brute_force_as_the_reference(dims, rank, procs):
    assert comm.check_grid_selection(dims, rank, procs) == [] == \
        ref.check_grid_selection(dims, rank, procs)


@pytest.mark.parametrize("dims,ranks,procs", comm.TUCKER_SELECT_CASES)
def test_tucker_grid_selection_matches_brute_force(dims, ranks, procs):
    assert comm.check_tucker_grid_selection(dims, ranks, procs) == [] == \
        ref.check_tucker_grid_selection(dims, ranks, procs)


def test_grid_suboptimal_fires_on_a_worse_choice(monkeypatch):
    import repro_torch.distributed.grid_select as gs

    best = gs.brute_force_stationary((8, 8, 8), 4, 8, mode=None)
    fake = types.SimpleNamespace(grid=(8, 1, 1), words=best.words * 2 + 1)
    monkeypatch.setattr(gs, "select_stationary_grid", lambda *a, **k: fake)
    assert _rules(comm.check_grid_selection((8, 8, 8), 4, 8)) == {"grid-suboptimal"}
    tbest = gs.brute_force_tucker((16, 16, 16), (4, 3, 2), 8)
    tfake = types.SimpleNamespace(grid=(8, 1, 1), words=tbest.words + 1)
    monkeypatch.setattr(gs, "select_tucker_grid", lambda *a, **k: tfake)
    assert _rules(comm.check_tucker_grid_selection((16, 16, 16), (4, 3, 2), 8)) == \
        {"grid-suboptimal"}


# --------------------------------------------------------------------------
# the byte rules on seeded faults
# --------------------------------------------------------------------------

def _alg3_with(extra, everyone=True):
    """Alg 3 at (8, 8, 8) on (2, 2, 2), plus ``extra(mesh, out)`` (on every
    rank, or on rank 0 only)."""
    from repro_torch.distributed.mttkrp_parallel import mttkrp_stationary, place_inputs
    from repro_torch.engine.context import ExecutionContext

    ctx = ExecutionContext.create("einsum", device="cpu", grid=(2, 2, 2))
    x, fs = comm._operands((8, 8, 8), (4, 4, 4))

    def program(mesh):
        xs, f_locs = place_inputs(mesh, x, fs, 0)
        out = mttkrp_stationary(mesh, 0, 3, ctx=ctx)(xs, *f_locs)
        if everyone or mesh.rank == 0:
            extra(mesh, out)

    return comm.count_ranks((2, 2, 2), program)


def test_an_extra_all_reduce_is_a_byte_model_mismatch():
    ranks = _alg3_with(lambda mesh, out: collectives.all_reduce(out, mesh.grid_group()))
    model = ref.mttkrp_model_bytes((8, 8, 8), 4, (2, 2, 2), 0)
    found, measured = comm._point("fixture", ranks, model, 0)
    assert _rules(found) == {"byte-model-mismatch"} and measured > model
    assert len(found) == 8  # every rank


def test_one_rank_off_the_program_is_an_asymmetry():
    ranks = _alg3_with(lambda mesh, out: collectives.all_reduce(out, mesh.grid_group()),
                       everyone=False)
    model = ref.mttkrp_model_bytes((8, 8, 8), 4, (2, 2, 2), 0)
    found, _ = comm._point("fixture", ranks, model, 0)
    assert _rules(found) == {"byte-model-mismatch", "rank-asymmetry"}


def test_below_lower_bound_fires():
    assert _rules(comm.check_program_bytes("fixture", 8, 8, 64)) == {"below-lower-bound"}
    assert _keys(comm.check_program_bytes("f", 8, 9, 64)) == \
        _keys(ref.check_program_bytes("f", 8, 9, 64))


def test_a_monolithic_gather_under_ring_overlap_is_flagged():
    ranks = _alg3_with(lambda mesh, out: None)  # Alg 3 gathers and reduce-scatters whole
    assert _rules(comm._ring_not_chunked("fixture", ranks)) == {"ring-not-chunked"}


def test_verify_comm_subset_is_clean_and_launches_nothing():
    findings, verdicts = comm.verify_comm(cp_cases=(((8, 8, 8), 4, (1, 2, 2)),),
                                          tucker_cases=(), mttkrp_cases=(),
                                          ring_sizes=(1, 2, 3))
    assert findings == []
    assert [v["name"] for v in verdicts] == ["cp_sweep/none", "cp_sweep/ring", "ring_schedule",
                                             "grid_selection"]


def test_a_launch_during_the_analysis_is_a_finding(monkeypatch):
    real = comm.check_cp_sweep

    def launching(*a, **kw):
        monkeypatch.setattr(mttkrp3_mod.mttkrp3, "launches", mttkrp3_mod.mttkrp3.launches + 1)
        return real(*a, **kw)

    monkeypatch.setattr(comm, "check_cp_sweep", launching)
    findings, _ = comm.verify_comm(cp_cases=(((8, 8, 8), 4, (1, 2, 2)),), tucker_cases=(),
                                   mttkrp_cases=(), ring_sizes=(2,))
    assert [f.rule for f in findings] == ["kernel-executed"]
