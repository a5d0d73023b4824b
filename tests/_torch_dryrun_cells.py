"""Helpers of the dry run's cell tests (``tests/test_torch_dryrun_cells.py``
and ``tests/test_torch_dryrun_multipod*.py``): one cut-depth cell, run as
the CLI runs it, and what its record must hold."""

import json

import torch.distributed as dist

from repro.configs import get_config as ref_get_config
from repro.models.sharding import attention_policy, moe_policy
from repro_torch.launch import dryrun

#: The families the mesh repairs touched: a dense decoder whose KV heads
#: do not divide tp (2 on 16), the MoE model (its expert counts), the
#: encoder-decoder model (6 heads: context parallelism).
ARCHS = ("qwen2-1.5b", "olmoe-1b-7b", "whisper-tiny")


def run(arch: str, shape: str, multi_pod: bool, out) -> dict:
    """The cell at one layer (and one microbatch, to train), its record
    checked against the file it wrote and its counts."""
    rec = dryrun.run_cell(arch, shape, multi_pod, str(out), mb_override=1, layers=1)
    assert not dist.is_initialized()
    mesh = "2x16x16" if multi_pod else "16x16"
    # a cut model's record has a file of its own, never the full cell's
    assert not (out / f"{arch}__{shape}__{mesh}.json").exists()
    with open(out / f"{arch}__{shape}__{mesh}__1L.json") as f:
        assert json.load(f) == rec
    ref_cfg = ref_get_config(arch)
    assert rec["status"] == "ok" and rec["n_layers"] == 1
    assert (rec["mesh"], rec["devices"]) == (mesh, 512 if multi_pod else 256)
    assert rec["attn_policy"] == attention_policy(ref_cfg, 16)
    assert rec["moe_policy"] == moe_policy(ref_cfg, 16)
    mem, cost, coll = rec["memory"], rec["cost"], rec["collectives"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes_est"]
    assert mem["output_bytes"] > 0 and cost["flops"] > 0
    assert cost["bytes_accessed"] > mem["argument_bytes"]
    assert coll["count"] == sum(k["count"] for k in coll["by_kind"].values()) > 0
    assert coll["ring_bytes"] == sum(k["ring_bytes"] for k in coll["by_kind"].values())
    if shape == "train_4k":
        assert rec["microbatches"] == 1 and rec["bf16_opt"] is (arch in dryrun.BF16_OPT_ARCHS)
        # the state is updated in place, the batch is not
        assert 0 < mem["alias_bytes"] < mem["argument_bytes"]
    else:
        assert mem["alias_bytes"] == 0
    return rec
