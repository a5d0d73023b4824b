"""The dry run's Shard-to-Shard redistribution: the all-to-all the card sends.

DTensor moves a shard to another dimension with ``shard_dim_alltoall``,
which on a CPU mesh gathers the whole dimension and keeps a chunk and on a
CUDA mesh runs ``_dtensor::shard_dim_alltoall``.
:func:`repro_torch.launch.dryrun.alltoall_as_on_card` makes the dry run's
CPU mesh over the ``fake`` group take the CUDA branch. Here:

* on a 16-rank ``fake`` group, a DTensor redistributed from ``Shard(0)``
  to ``Shard(1)`` under ``StepCost`` and ``MemTracker`` counts exactly one
  all-to-all of the local shard's bytes, ``15/16`` of them on the ring, no
  all-gather, and a peak without a gathered temporary 16 times the shard;
* ``CommDebugMode`` on the same step counts the same kinds, even and
  uneven shards alike;
* a torch without the op, or without the name replaced, is refused;
* on a (2, 2) gloo mesh, after a ``run_cell`` in the same process, the
  same redistribution runs as torch runs it (the gather and the chunk) and
  gives the chunk of the whole tensor: the replacement was scoped to the
  dry run and restored.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import dryrun

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
Q = 16
#: Global shapes redistributed from Shard(0) to Shard(1): one that splits
#: evenly over Q ranks, and one that splits unevenly in both dimensions.
SHAPES = {"even": (1024, 256), "uneven": (1000, 250)}
#: The gloo mesh, its redistributed shapes, and the seconds its ranks may take.
GLOO_MESH = (2, 2)
GLOO_SHAPES = {"even": (8, 12), "uneven": (7, 9)}
TIMEOUT = 240


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=Q)
    yield
    dist.destroy_process_group()


def _redistribute(shape) -> dict:
    """``shape`` sharded over the group's Q ranks on dim 0, moved to dim 1
    under the dry run's modes: the counter's collectives, CommDebugMode's
    count by kind, the tracker's peak and the shards' local shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.debug import CommDebugMode

    mesh = init_device_mesh("cpu", (Q,))
    with FakeTensorMode():
        whole = torch.zeros(shape, dtype=torch.bfloat16)
        local = whole[: -(-shape[0] // Q)].clone()
        x = DTensor.from_local(local, mesh, [Shard(0)], run_check=False, shape=whole.shape,
                               stride=whole.stride())
        tracker, cost, comm = MemTracker(), dryrun.StepCost(), CommDebugMode()
        tracker.track_external(x)
        with dryrun.propagation_apart(), dryrun.alltoall_as_on_card(), comm, tracker, cost:
            y = x.redistribute(mesh, [Shard(1)])
        peak = max(s["Total"] for s in tracker.get_tracker_snapshot("peak").values())
    kinds: dict[str, int] = {}
    for op, n in comm.get_comm_counts().items():
        kind = dryrun.COLLECTIVE_KINDS[op.__name__.split(".")[-1]]
        kinds[kind] = kinds.get(kind, 0) + n
    return {"cost": cost, "comm": kinds, "peak": peak, "local": tuple(local.shape),
            "out": tuple(y.to_local().shape), "shard_bytes": local.numel() * 2}


def test_a_shard_move_is_one_all_to_all_of_the_shard(fake_group):
    got = _redistribute(SHAPES["even"])
    shard = got["shard_bytes"]
    assert got["local"] == (64, 256) and got["out"] == (1024, 16)
    assert got["cost"].by_kind == {"all-to-all": {"count": 1, "operand_bytes": shard,
                                                  "ring_bytes": shard * (Q - 1) // Q}}
    assert got["cost"].flops == 0


def test_the_op_is_a_collective_and_no_ordinary_op(fake_group):
    from torch._subclasses.fake_tensor import FakeTensorMode

    name = dist.group.WORLD.group_name
    with FakeTensorMode():
        x = torch.zeros(64, 256, dtype=torch.bfloat16)
        cost = dryrun.StepCost()
        with cost:
            out = torch.ops._dtensor.shard_dim_alltoall(x, 0, 1, name)
    assert tuple(out.shape) == (64 * Q, 256 // Q)
    assert cost.by_kind == {"all-to-all": {"count": 1, "operand_bytes": 32768,
                                           "ring_bytes": 32768 * (Q - 1) // Q}}
    assert cost.flops == 0 and cost.bytes_accessed == 0


def test_a_shard_move_holds_no_gathered_temporary(fake_group):
    got = _redistribute(SHAPES["even"])
    # the input shard and the output shard, each shard-sized; torch's CPU
    # branch holds the Q-times gather besides (589,824 bytes here)
    assert got["peak"] == 2 * got["shard_bytes"]


@pytest.mark.parametrize("form", list(SHAPES))
def test_comm_debug_mode_counts_the_same_kinds(fake_group, form):
    got = _redistribute(SHAPES[form])
    counter = {k: v["count"] for k, v in got["cost"].by_kind.items()}
    assert counter == got["comm"] == {"all-to-all": 1}
    assert got["out"] == (SHAPES[form][0], -(-SHAPES[form][1] // Q))


def test_the_uneven_shard_is_padded_around_the_all_to_all(fake_group):
    got = _redistribute(SHAPES["uneven"])
    # DTensor pads the 250 columns to 16 x 16 before the call
    operand = -(-SHAPES["uneven"][0] // Q) * 256 * 2
    assert got["cost"].by_kind["all-to-all"]["operand_bytes"] == operand
    assert got["cost"].by_kind["all-to-all"]["ring_bytes"] == operand * (Q - 1) // Q


def test_a_torch_without_the_name_replaced_is_refused(fake_group, monkeypatch):
    from torch.distributed.tensor import placement_types

    monkeypatch.delattr(placement_types, "shard_dim_alltoall")
    with pytest.raises(RuntimeError, match="placement_types has no shard_dim_alltoall"):
        with dryrun.alltoall_as_on_card():
            pass


def test_a_torch_without_the_op_is_refused(fake_group, monkeypatch):
    from torch.distributed.tensor import placement_types

    own = placement_types.shard_dim_alltoall
    monkeypatch.setattr(dryrun, "ALLTOALL", ("_dtensor", "no_such_alltoall"))
    with pytest.raises(RuntimeError, match="no op _dtensor::no_such_alltoall"):
        with dryrun.alltoall_as_on_card():
            pass
    assert placement_types.shard_dim_alltoall is own


def test_the_replacement_is_restored(fake_group):
    from torch.distributed.tensor import _collective_utils, placement_types

    own = placement_types.shard_dim_alltoall
    assert own is _collective_utils.shard_dim_alltoall
    with dryrun.alltoall_as_on_card():
        assert placement_types.shard_dim_alltoall is not own
        assert _collective_utils.shard_dim_alltoall is placement_types.shard_dim_alltoall
    assert placement_types.shard_dim_alltoall is own is _collective_utils.shard_dim_alltoall


def test_outside_a_fake_group_it_is_refused():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="fake backend only"):
        with dryrun.alltoall_as_on_card():
            pass


def test_run_cell_counts_all_to_alls(tmp_path):
    rec = dryrun.run_cell("mamba2-2.7b", "decode_32k", False, str(tmp_path), layers=1)
    a2a = rec["collectives"]["by_kind"]["all-to-all"]
    assert a2a["count"] > 0 and a2a["ring_bytes"] == pytest.approx(
        a2a["operand_bytes"] * (Q - 1) / Q, abs=a2a["count"])
    assert "all-to-all a CUDA mesh runs" in rec["notes"]["collectives"]


# --------------------------------------------------------------------------
# The gloo worker: a dry run, then torch's own redistribution on a real mesh
# --------------------------------------------------------------------------

def _whole(shape) -> torch.Tensor:
    rng = np.random.default_rng(37 + shape[0])
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


def worker(rank: int, store: str, records: str, out: str) -> None:
    sys.path.insert(0, SRC)
    from torch.distributed.tensor import DTensor, Replicate, Shard, _collective_utils
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.dryrun import alltoall_as_on_card, run_cell
    from repro_torch.launch.mesh import make_debug_mesh

    torch.set_num_threads(1)
    rec = run_cell("mamba2-2.7b", "decode_32k", False, records, layers=1)
    dp, tp = GLOO_MESH
    dist.init_process_group("gloo", store=dist.FileStore(store, dp * tp), rank=rank,
                            world_size=dp * tp)
    mesh = make_debug_mesh(dp, tp, device_type="cpu")
    result = {"dry_run_all_to_alls": rec["collectives"]["by_kind"]["all-to-all"]["count"],
              "restored": placement_types.shard_dim_alltoall is _collective_utils.shard_dim_alltoall
              and placement_types.shard_dim_alltoall.__module__ == _collective_utils.__name__}
    for form, shape in GLOO_SHAPES.items():
        whole = _whole(shape)
        x = DTensor.from_local(torch.chunk(whole, tp, 0)[mesh.get_coordinate()[1]], mesh,
                               [Replicate(), Shard(0)], run_check=False, shape=whole.shape,
                               stride=whole.stride())
        comm = CommDebugMode()
        with comm:
            y = x.redistribute(mesh, [Replicate(), Shard(1)])
        want = torch.chunk(whole, tp, 1)[mesh.get_coordinate()[1]]
        result[form] = {"equal": torch.equal(y.to_local(), want),
                        "counts": {str(k): v for k, v in comm.get_comm_counts().items()}}
    try:
        with alltoall_as_on_card():
            pass
        result["refused"] = False
    except RuntimeError as e:
        result["refused"] = "fake backend only" in str(e)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("alltoall_gloo")
    env = {**os.environ, "PYTHONPATH": SRC, "GLOO_SOCKET_IFNAME": os.environ.get(
        "GLOO_SOCKET_IFNAME", "lo"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(r), str(tmp / "store"),
         str(tmp / f"records{r}"), str(tmp / "out.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(GLOO_MESH[0] * GLOO_MESH[1])]
    bad = []
    try:
        for r, p in enumerate(procs):
            text = p.communicate(timeout=TIMEOUT)[0]
            if p.returncode:
                bad.append(f"rank {r} rc={p.returncode}:\n{text[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not bad, "\n".join(bad)
    with open(tmp / "out.json") as f:
        return json.load(f)


def test_the_dry_run_before_the_gloo_mesh_counted_all_to_alls(gloo):
    assert gloo["dry_run_all_to_alls"] > 0 and gloo["restored"]


@pytest.mark.parametrize("form", list(GLOO_SHAPES))
def test_a_gloo_mesh_keeps_torchs_redistribution(gloo, form):
    # torch's CPU branch: the gather and the chunk, and the right chunk
    assert gloo[form]["equal"]
    assert gloo[form]["counts"] == {"c10d_functional.all_gather_into_tensor": 1}


def test_a_gloo_group_is_refused(gloo):
    assert gloo["refused"]


if __name__ == "__main__" and sys.argv[1] == "worker":
    worker(int(sys.argv[2]), *sys.argv[3:6])
