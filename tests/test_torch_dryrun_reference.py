"""The dry run's costs of sixteen cells against the reference's own dry
run of the same cells, at one layer on the 16x16 mesh.

The reference (``repro.launch.dryrun.run_cell``) lowers and compiles each
cell for 256 fake XLA host devices, in a subprocess of its own with its
512-device ``XLA_FLAGS``; there, and only there, ``repro.configs.get_config``
is wrapped to cut the config to one layer (``dataclasses.replace(cfg,
n_layers=1)``, the encoder-decoder model's decoder too, as the port's
``run_cell(layers=1)`` cuts it). The port's ``run_cell(layers=1)`` runs the same cell, once
for all of its checks. Each pair must count the same parameters, and the
port must keep the reference's sharding where it costs the most. Each
cell checks a tuple of numbers, each at most a multiple of the
reference's (a test case each):

* ``qwen2-1.5b decode_32k``: one device's FLOPs (the decode core on the
  sequence-sharded cache; before, each rank attended its rows over the
  whole cache, 4.1 times the reference's), ring bytes and peak (the
  vocabulary-parallel lookup; before, every rank gathered the whole
  token table for each token, 5.4 and 6.3 times), all at 1.25 times;
* ``qwen2-vl-72b decode_32k``: the same under ``head_tp`` (its 64 heads
  divide tp), whose decode core also runs on the sequence-sharded cache;
* ``mamba2-2.7b decode_32k``: ring bytes and peak at 1.25 times (the
  lookup; before, 6.5 and 10.7 times);
* ``olmoe-1b-7b prefill_32k``: the peak at most 2 times the reference's
  (MoE on each rank's own tokens; before, 14.9 times);
* ``qwen2-1.5b train_4k``: the peak at most 2 times the reference's (the
  vocabulary-parallel loss; before, 13 times);
* ``qwen2-vl-72b train_4k`` (16 microbatches of embeddings): ring bytes
  at most 2 times (the microbatch split that moves each part alone, and
  the head gathered for the logits; before, every rank gathered the
  whole batch for each microbatch, 4.95 times) and the peak at 1.25
  times (before, 2.74 times);
* ``mamba2-2.7b prefill_32k``: the peak at 1.25 times (the causal conv
  on each rank's own channels; before, every rank convolved every
  channel, 2.42 times) and FLOPs at 1.25 times;
* ``nemotron-4-340b train_4k`` (16 microbatches, ``head_tp``): ring bytes
  at 1.75 times (the norm's gradient laid out once in the norm's layout,
  the attention output projection's weight gathered and its output's
  gradient summed; before, 2.57 times) and at 1.0 times (each
  Shard-to-Shard redistribution counted as the all-to-all the card
  sends; before, as the CPU mesh's gather of the whole dimension, 1.439
  times), the peak at 1.25 times (before,
  1.36 times) and FLOPs at 1.25 times (before, 1.33 times: the output
  projection's backward computed every head's gradient on every rank);
* ``mamba2-2.7b train_4k`` (8 microbatches): FLOPs, ring bytes and the
  peak at 1.25 times (the SSM's output projection with its output's
  gradient summed once and laid out as the output, and the gate's
  gradient laid out as the gate is; before, the backward computed every
  channel of both products on every rank, 1.73 times the reference's
  FLOPs); its ring bytes also at 0.25 times (the gated norm on each
  rank's own channels, one all-reduce of its (rows, 1) statistic each
  way; before, its backward gathered (B, S, d_inner) operands, 0.879
  times);
* ``qwen2-vl-72b``, ``whisper-tiny``, ``nemotron-4-340b``, ``qwen2-1.5b``,
  ``deepseek-coder-33b`` and ``yi-34b`` ``prefill_32k``: the peak at 1.25
  times (serving's norms in place on one fp32 copy, the normed input and
  the mixer's output dead before the FFN, RoPE's tables on each rank's own
  batch rows; before, 1.35-1.84 times);
* ``mamba2-2.7b long_500k`` (one sequence, the batch replicated over dp):
  FLOPs, ring bytes and the peak at 1.25 times (the decode step's step
  sizes on each rank's own heads, as the cache's state is laid out, and
  the padded vocabulary's mask in int32; before, the state's update term
  was computed for every head on every rank, 1.100 times the reference's
  FLOPs and 2.592 times its peak).

The factor of 2 on a train step's or a prefill's memory leaves room for
the two ways of counting a peak: the port's ``MemTracker`` counts live
bytes, the reference takes XLA's arguments plus temporaries.

``_start`` is also the reference's side of a whole comparison:
``scripts/dryrun_layers.py sweep --reference`` runs it on every cell.
"""

import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro_torch.launch import dryrun

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
LAYERS = 1
#: (arch, shape) -> its checks: (the record's number, the port's limit as a
#: multiple of the reference's)
CELLS = {("qwen2-1.5b", "decode_32k"): (("flops", 1.25), ("ring_bytes", 1.25),
                                        ("peak_bytes_est", 1.25)),
         ("qwen2-vl-72b", "decode_32k"): (("flops", 1.25), ("ring_bytes", 1.25),
                                          ("peak_bytes_est", 1.25)),
         ("olmoe-1b-7b", "prefill_32k"): (("peak_bytes_est", 2.0),),
         ("qwen2-1.5b", "train_4k"): (("peak_bytes_est", 2.0),),
         ("mamba2-2.7b", "decode_32k"): (("ring_bytes", 1.25), ("peak_bytes_est", 1.25)),
         ("qwen2-vl-72b", "train_4k"): (("ring_bytes", 2.0), ("peak_bytes_est", 1.25)),
         ("mamba2-2.7b", "prefill_32k"): (("peak_bytes_est", 1.25), ("flops", 1.25)),
         ("nemotron-4-340b", "train_4k"): (("ring_bytes", 1.75), ("peak_bytes_est", 1.25),
                                           ("flops", 1.25), ("ring_bytes", 1.0)),
         ("mamba2-2.7b", "train_4k"): (("flops", 1.25), ("ring_bytes", 1.25),
                                       ("peak_bytes_est", 1.25), ("ring_bytes", 0.25)),
         ("qwen2-vl-72b", "prefill_32k"): (("peak_bytes_est", 1.25),),
         ("whisper-tiny", "prefill_32k"): (("peak_bytes_est", 1.25),),
         ("nemotron-4-340b", "prefill_32k"): (("peak_bytes_est", 1.25),),
         ("qwen2-1.5b", "prefill_32k"): (("peak_bytes_est", 1.25),),
         ("deepseek-coder-33b", "prefill_32k"): (("peak_bytes_est", 1.25),),
         ("yi-34b", "prefill_32k"): (("peak_bytes_est", 1.25),),
         ("mamba2-2.7b", "long_500k"): (("flops", 1.25), ("ring_bytes", 1.25),
                                        ("peak_bytes_est", 1.25))}
CHECKS = [(arch, shape, key, limit) for (arch, shape), checks in CELLS.items()
          for key, limit in checks]
TIMEOUT = 240

#: The reference's cell at ``argv[3]`` layers, its record printed as JSON.
REF_CHILD = r"""
import dataclasses, json, sys
import repro.configs as configs
from repro.launch import dryrun

own, n = configs.get_config, int(sys.argv[3])
configs.get_config = lambda name: dataclasses.replace(
    own(name), n_layers=n, dec_layers=min(own(name).dec_layers, n))
print(json.dumps(dryrun.run_cell(sys.argv[1], sys.argv[2], False, sys.argv[4])))
"""


def _start(arch: str, shape: str, layers: int, out: str) -> subprocess.Popen:
    """The reference's cell at ``layers``, in a subprocess of its own."""
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    return subprocess.Popen([sys.executable, "-c", REF_CHILD, arch, shape, str(layers), out],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Each cell's reference run, all started at once: ``(arch, shape)`` ->
    a function that waits for its record."""
    procs = {cell: _start(*cell, LAYERS, str(tmp_path_factory.mktemp("ref"))) for cell in CELLS}

    def record(cell):
        proc = procs[cell]
        out, err = proc.communicate(timeout=TIMEOUT)
        assert proc.returncode == 0, err[-4000:]
        return json.loads(out.strip().splitlines()[-1])

    yield record
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Each cell's port run, once for all of its checks: ``(arch, shape)``
    -> its record."""
    records = {}

    def record(cell):
        if cell not in records:
            records[cell] = dryrun.run_cell(*cell, False, str(tmp_path_factory.mktemp("port")),
                                            layers=LAYERS)
            assert not dist.is_initialized()
        return records[cell]

    return record


def _number(rec: dict, key: str) -> int:
    if key == "flops":
        return rec["cost"][key]
    return rec["collectives"][key] if key == "ring_bytes" else rec["memory"][key]


@pytest.mark.parametrize("arch,shape,key,limit", CHECKS)
def test_the_cost_is_within_the_references(reference, port, arch, shape, key, limit):
    rec = port((arch, shape))
    ref = reference((arch, shape))
    assert ref["status"] == rec["status"] == "ok"
    # the cut reached the reference: both count the same one-layer model
    assert ref["params"] == rec["params"] and rec["n_layers"] == LAYERS
    assert (ref["attn_policy"], ref["moe_policy"]) == (rec["attn_policy"], rec["moe_policy"])
    assert ref.get("microbatches") == rec.get("microbatches")
    got, want = _number(rec, key), _number(ref, key)
    assert 0 < got <= limit * want, (f"{arch} {shape} {key}: port {got}, reference {want}, "
                                     f"{got / want:.3f}x over {limit}x")
