"""The port's dry run (``repro_torch.launch.dryrun``, ``launch/specs.py``,
``analysis/report.py``, ``roofline_from_record``) against the reference's
on the CPU.

The reference lowers and compiles each cell for 256 or 512 fake XLA
devices; the port runs the step once on ``FakeTensorMode`` tensors over a
fake process group and counts rank 0's local ops (``docs/PORT.md``, slice
20). Held here:

* the input structs of all 40 cells and ``pick_microbatches`` equal to the
  reference's;
* ``mamba2-2.7b decode_32k 16x16`` at full depth against the reference's
  committed record (``results/dryrun/``): the argument bytes to the byte,
  the parameter and model-FLOP counts exactly, one device's FLOPs within
  10 % (the reference counts XLA's fused HLO, the port the aten ops), its
  keys, and the collectives by kind equal to ``CommDebugMode``'s count of
  the same step;
* each kind's ring bytes by its formula, over the collective's own group;
* one device's FLOPs: a smoke prefill on a (2, 2) mesh reads a quarter of
  its (1, 1) count, where every matmul is split four ways;
* ``roofline_from_record`` equal to the reference's on its record, and the
  report's tables.

The cut-depth cells of the three repaired families are in
``tests/test_torch_dryrun_cells.py``.
"""

import json
import os
from dataclasses import asdict

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCH_NAMES, all_cells
from repro.launch import specs as ref_specs
from repro_torch.launch import dryrun, specs
from repro_torch.models import ArchConfig

HERE = os.path.dirname(os.path.abspath(__file__))
REF_RECORD = os.path.join(HERE, "..", "results", "dryrun", "mamba2-2.7b__decode_32k__16x16.json")
#: The reference's record keys the port does not write (docs/PORT.md, slice 20).
ABSENT = {"lower_s", "compile_s", "cost_raw", "memory.temp_bytes", "memory.code_bytes"}
#: CommDebugMode's op names by the reference's kind names.
COMM_KINDS = {"all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
              "all_reduce": "all-reduce", "all_to_all_single": "all-to-all",
              "shard_dim_alltoall": "all-to-all"}


def _ref_dryrun():
    """The reference's dry-run module, imported without leaving its
    512-device ``XLA_FLAGS`` behind (it sets them at import, before any
    jax import; no jax is imported there)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return ref


def _ref_record() -> dict:
    with open(REF_RECORD) as f:
        return json.load(f)


# --------------------------------------------------------------------------
# specs and settings
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in all_cells()])
def test_input_specs_match_the_reference(arch, shape):
    want = ref_specs.input_specs(arch, shape)
    got = specs.input_specs(arch, shape)
    assert list(got) == list(want)
    for part in want:
        w = want[part] if isinstance(want[part], dict) else {"": want[part]}
        g = got[part] if isinstance(got[part], dict) else {"": got[part]}
        assert list(g) == list(w)
        for k in w:
            assert g[k].device.type == "meta"
            assert tuple(g[k].shape) == tuple(w[k].shape)
            assert str(g[k].dtype).removeprefix("torch.") == str(w[k].dtype)


@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES if a != "mamba2-2.7b"])  # no heads
def test_cross_kv_struct_matches_the_reference(arch):
    from repro.configs import get_config as ref_get_config
    from repro.models.config import SHAPES

    ref_cfg = ref_get_config(arch)
    shape = SHAPES["decode_32k"]
    want = ref_specs.cross_kv_struct(ref_cfg, shape)
    got = specs.cross_kv_struct(ArchConfig(**asdict(ref_cfg)), shape)
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    assert [str(t.dtype).removeprefix("torch.") for t in got] == [str(t.dtype) for t in want]


@pytest.mark.parametrize("arch", [*ARCH_NAMES, "unknown"])
def test_pick_microbatches_matches_the_reference(arch):
    ref = _ref_dryrun()
    for batch in (1, 2, 3, 8, 16, 32, 48, 128, 256, 512):
        for dp in (1, 2, 4, 8, 16, 32, 256, 512):
            assert dryrun.pick_microbatches(arch, batch, dp) == ref.pick_microbatches(
                arch, batch, dp), (batch, dp)


def test_settings_match_the_reference():
    ref = _ref_dryrun()
    assert dryrun.MICROBATCHES == ref.MICROBATCHES
    assert dryrun.BF16_OPT_ARCHS == ref.BF16_OPT_ARCHS


# --------------------------------------------------------------------------
# the mamba2 decode cell at full depth against the reference's record
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba(tmp_path_factory):
    """The cell's record, and CommDebugMode's count of the same step (the
    debug mode entered around the step, beside the dry run's own)."""
    import contextlib

    from torch.distributed.tensor.debug import CommDebugMode

    comm = CommDebugMode()
    apart = dryrun.propagation_apart

    @contextlib.contextmanager
    def watched():
        with apart(), comm:
            yield

    out = tmp_path_factory.mktemp("dryrun")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dryrun, "propagation_apart", watched)
        rec = dryrun.run_cell("mamba2-2.7b", "decode_32k", False, str(out))
    assert not dist.is_initialized()
    with open(out / "mamba2-2.7b__decode_32k__16x16.json") as f:
        assert json.load(f) == rec
    counts: dict[str, int] = {}
    for op, n in comm.get_comm_counts().items():
        kind = COMM_KINDS[op.__name__.split(".")[-1]]
        counts[kind] = counts.get(kind, 0) + n
    return rec, counts


def test_mamba_decode_argument_bytes_are_the_references(mamba):
    assert mamba[0]["memory"]["argument_bytes"] == _ref_record()["memory"]["argument_bytes"] \
        == 131_754_272


def test_mamba_decode_counts_are_the_references(mamba):
    rec, ref = mamba[0], _ref_record()
    for key in ("arch", "shape", "mesh", "devices", "attn_policy", "moe_policy", "shard_batch",
                "params", "active_params", "model_flops", "status"):
        assert rec[key] == ref[key], key


def test_mamba_decode_flops_are_one_devices(mamba):
    got, want = mamba[0]["cost"]["flops"], _ref_record()["cost"]["flops"]
    assert abs(got - want) <= 0.10 * want, (got, want)


def test_mamba_decode_record_has_the_references_keys(mamba):
    def keys(rec):
        out = set(rec)
        for part in ("memory", "cost", "collectives"):
            out |= {f"{part}.{k}" for k in rec[part]}
        return out

    rec = mamba[0]
    assert keys(_ref_record()) - ABSENT <= keys(rec)
    assert set(rec["collectives"]["by_kind"]) <= {"all-gather", "reduce-scatter", "all-reduce",
                                                  "all-to-all", "collective-permute"}
    assert rec["trace_s"] > 0 and rec["memory"]["peak_bytes_est"] >= rec["memory"][
        "argument_bytes"]
    assert "upper bound" in rec["notes"]["cost.bytes_accessed"]


def test_mamba_decode_collectives_are_comm_debug_modes_count(mamba):
    rec, counts = mamba
    by_kind = rec["collectives"]["by_kind"]
    assert {k: v["count"] for k, v in by_kind.items()} == counts
    assert rec["collectives"]["count"] == sum(counts.values()) > 0


def test_mamba_decode_ring_bytes_follow_the_formulas(mamba):
    # every group of the 16x16 mesh has 16 ranks
    by_kind, q = mamba[0]["collectives"]["by_kind"], 16
    ag, rs, ar = by_kind["all-gather"], by_kind["reduce-scatter"], by_kind["all-reduce"]
    assert ag["ring_bytes"] == (q - 1) * ag["operand_bytes"]
    assert rs["ring_bytes"] == (q - 1) * rs["operand_bytes"] // q
    assert abs(ar["ring_bytes"] - 2 * (q - 1) / q * ar["operand_bytes"]) <= ar["count"]
    # a Shard-to-Shard redistribution, as the card sends it
    a2a = by_kind["all-to-all"]
    assert a2a["count"] > 0
    assert abs(a2a["ring_bytes"] - (q - 1) / q * a2a["operand_bytes"]) <= a2a["count"]


# --------------------------------------------------------------------------
# the counters
# --------------------------------------------------------------------------

@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def open_(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)

    yield open_
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("q", [2, 16])
def test_each_kinds_ring_bytes_over_its_group(fake_group, q):
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake_group(q)
    name, ops = dist.group.WORLD.group_name, torch.ops._c10d_functional
    with FakeTensorMode():
        x = torch.zeros(64, 8)  # 2048 bytes
        cost = dryrun.StepCost()
        with cost:  # the ops DTensor issues, each with its wait
            for out in (ops.all_gather_into_tensor(x, q, name),
                        ops.reduce_scatter_tensor(x, "sum", q, name),
                        ops.all_reduce(x, "sum", name),
                        ops.all_to_all_single(x, [64 // q] * q, [64 // q] * q, name)):
                ops.wait_tensor(out)
    n = 64 * 8 * 4
    want = {"all-gather": (q - 1) * n, "reduce-scatter": (q - 1) * n // q,
            "all-reduce": int(2 * (q - 1) / q * n), "all-to-all": int((q - 1) / q * n)}
    assert {k: v["ring_bytes"] for k, v in cost.by_kind.items()} == want
    assert {k: (v["count"], v["operand_bytes"]) for k, v in cost.by_kind.items()} == {
        k: (1, n) for k in want}
    assert cost.flops == 0


def test_ring_bytes_formulas():
    from repro_torch.distributed.collectives import ring_bytes

    assert ring_bytes("all-gather", 100, 1600, 16) == 1500
    assert ring_bytes("reduce-scatter", 1600, 100, 16) == 1500
    assert ring_bytes("all-reduce", 1600, 1600, 16) == 3000
    assert ring_bytes("all-to-all", 1600, 1600, 16) == 1500
    assert ring_bytes("collective-permute", 100, 100, 16) == 100
    with pytest.raises(ValueError, match="unknown collective kind"):
        ring_bytes("broadcast", 1, 1, 2)


def _prefill_flops(name: str, n: int) -> int:
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.config import RunShape
    from repro_torch.models.sharding import make_policy
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cfg = get_smoke(name)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n * n)
    try:
        sh = make_policy(cfg, make_debug_mesh(n, n, device_type="cpu"))
        return dryrun._measure(cfg, RunShape("t", 64, 8, "prefill"), sh, 1, False)["cost"]["flops"]
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["qwen2-1.5b", "olmoe-1b-7b"])
def test_flops_are_one_devices(name):
    one, four = _prefill_flops(name, 1), _prefill_flops(name, 2)
    assert one > 0 and abs(four / one - 0.25) <= 0.01, (one, four)


def test_shape_propagation_is_kept_apart():
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    own = ShardingPropagator.__dict__[name]
    with dryrun.propagation_apart():
        assert ShardingPropagator.__dict__[name] is not own
    assert ShardingPropagator.__dict__[name] is own


def test_the_dry_run_refuses_an_open_group(fake_group, tmp_path):
    fake_group(4)
    with pytest.raises(RuntimeError, match="already initialized"):
        dryrun.run_cell("qwen2-1.5b", "decode_32k", False, str(tmp_path))


def test_a_skipped_cell_writes_its_reason(tmp_path):
    rec = dryrun.run_cell("qwen2-1.5b", "long_500k", True, str(tmp_path))
    assert rec["status"] == "skipped" and "full-attention" in rec["reason"]
    assert rec["mesh"] == "2x16x16" and rec["devices"] == 512
    with open(tmp_path / "qwen2-1.5b__long_500k__2x16x16.json") as f:
        assert json.load(f) == rec
    assert not dist.is_initialized()


# --------------------------------------------------------------------------
# the roofline and the report
# --------------------------------------------------------------------------

def test_roofline_from_record_is_the_references():
    from repro.analysis.roofline import roofline_from_record as ref_roofline_from_record
    from repro_torch.analysis import HW, roofline_from_record

    rec = _ref_record()
    want = ref_roofline_from_record(rec)
    got = roofline_from_record(rec, HW("tpu-v5e", {"bfloat16": 197e12}, 819e9, 50e9))
    for field in ("t_compute", "t_memory", "t_collective", "flops_per_device",
                  "bytes_per_device", "collective_bytes_per_device", "model_flops_total",
                  "useful_ratio", "bottleneck", "hw"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.step_time, got.step_time_overlapped, got.mfu_bound) == (
        want.step_time, want.step_time_overlapped, want.mfu_bound)


def test_roofline_from_record_defaults_to_the_h100():
    from repro_torch.analysis import H100, roofline_from_record

    rec = _ref_record()
    rt = roofline_from_record(rec)
    assert rt.hw == H100.name
    assert rt.t_compute == rec["cost"]["flops"] / H100.peak_flops["bfloat16"]
    assert roofline_from_record(rec, dtype="float32").t_compute == (
        rec["cost"]["flops"] / H100.peak_flops["float32"])


def test_report_renders_ok_and_skipped_records(tmp_path, capsys):
    from repro_torch.analysis import report

    ok = _ref_record()
    big = dict(ok, arch="qwen2-1.5b", memory=dict(ok["memory"], peak_bytes_est=81 * 10 ** 9))
    skipped = {"arch": "qwen2-1.5b", "shape": "long_500k", "mesh": "16x16", "devices": 256,
               "status": "skipped", "reason": "pure full-attention"}
    cut = dict(ok, n_layers=1)
    for i, rec in enumerate((ok, big, skipped, cut)):
        with open(tmp_path / f"{i}.json", "w") as f:
            json.dump(rec, f)
    recs = report.load(str(tmp_path))
    table = report.dryrun_table(recs).splitlines()
    assert "fits H100" in table[0] and len(table) == 6
    assert "| ok | 0.2GiB | Y | 2.74e+09 |" in table[2]
    assert "| ok | 75.4GiB | N | 2.74e+09 |" in table[3]  # over the card's 80 GB
    assert table[4].endswith("| skip | – | – | – | – | – | – |")
    assert "agather×515,areduce×193,ato-all×1," in table[2]  # the reference's abbreviations
    # a cut model's record names its depth, in every table
    assert table[5].startswith("| mamba2-2.7b [n_layers=1] | decode_32k |")
    assert table[2].startswith("| mamba2-2.7b | decode_32k |")
    roof = report.roofline_table(recs).splitlines()
    assert len(roof) == 5 and "**" in roof[2]
    assert roof[4].startswith("| mamba2-2.7b [n_layers=1] |")
    picks = report.pick_hillclimb(recs)
    assert [why.split()[0] for _, why in picks] == ["worst", "most"]
    report.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "## Dry-run matrix" in out and "NVIDIA H100" in out and "Hillclimb" in out
    assert np.isfinite(report.roofline_from_record(ok).step_time)
