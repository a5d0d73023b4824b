"""The production dry run, the port of ``repro/launch/dryrun.py``.

For each (arch x shape x mesh) cell: build the production-sharded train
step, prefill or serve step, run it ONCE on fake tensors over a fake
process group of the mesh's size, and record what one device holds,
computes and sends:

  * ``memory``: the local shard bytes of everything the step takes
    (``argument_bytes``), of what it updates in place (``alias_bytes``,
    the reference's donation) and of what it returns (``output_bytes``),
    and the peak of live local bytes (``peak_bytes_est``, from
    ``torch.distributed._tools.mem_tracker.MemTracker``);
  * ``cost``: the FLOPs (``torch.utils.flop_counter``'s formulas) and the
    operand plus output bytes of every local aten op one device runs;
  * ``collectives``: every functional collective the step issues, by kind
    (the reference's names), with operand and ring bytes,

into ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --arch ... --shape ... --multipod
  python -m repro_torch.launch.dryrun --all [--force]     # subprocess per cell

The reference lowers and compiles each cell for 256 or 512 fake XLA host
devices. The port has no compiler to ask, so it runs the step instead:
the mesh is :func:`~repro_torch.launch.mesh.make_production_mesh` on a
process group of the ``fake`` backend (one process stands for rank 0 and
every collective returns at once), and the state, the batch and every
intermediate are ``FakeTensorMode`` tensors on the CPU, so nothing is
allocated and no GPU is needed. DTensor runs its sharding rules as on a
real mesh and hands each op rank 0's local shards; :class:`StepCost`
counts those. On CPU tensors ``ssd_intra`` takes its plain version, so
the FLOPs of an SSM layer's intra-chunk term are ``ssd_intra_plain``'s
einsums. ``docs/PORT.md`` (slice 20) says what differs from the
reference's record.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from collections.abc import Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..distributed.collectives import ring_bytes

RESULTS_DIR = os.environ.get(
    "REPRO_TORCH_DRYRUN_DIR",
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch"),
)

# ---------------------------------------------------------------------------
# per-(arch, shape) launch settings (memory tuning knobs), the reference's
# ---------------------------------------------------------------------------

MICROBATCHES = {  # desired microbatch count for train_4k (clamped per mesh)
    "nemotron-4-340b": 16,
    "qwen2-vl-72b": 16,
    "yi-34b": 16,
    "deepseek-coder-33b": 16,
    "jamba-v0.1-52b": 16,
    "mamba2-2.7b": 8,
    "olmoe-1b-7b": 8,
    "granite-moe-3b-a800m": 4,
    "qwen2-1.5b": 4,
    "whisper-tiny": 2,
}

BF16_OPT_ARCHS = {  # bf16 Adam moments + bf16 grad accumulation
    "nemotron-4-340b",
    "qwen2-vl-72b",
}


def pick_microbatches(arch: str, global_batch: int, dp_size: int) -> int:
    want = MICROBATCHES.get(arch, 4)
    mb = min(want, max(global_batch // dp_size, 1))
    while mb > 1 and (global_batch % mb or (global_batch // mb) % dp_size):
        mb -= 1
    return max(mb, 1)


# ---------------------------------------------------------------------------
# counting one device's work
# ---------------------------------------------------------------------------

#: The collectives DTensor issues, by op name, under the reference's kind
#: names: the functional collectives (``_c10d_functional``) and the
#: all-to-all of a Shard-to-Shard redistribution
#: (``_dtensor::shard_dim_alltoall``, which :func:`alltoall_as_on_card`
#: makes the dry run's CPU mesh run as a CUDA mesh does).
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
#: The op a CUDA mesh runs for a Shard-to-Shard redistribution.
ALLTOALL = ("_dtensor", "shard_dim_alltoall")

NOTES = {
    "cost.flops": "torch.utils.flop_counter's formulas over the aten ops one device runs on "
                  "its local shards (DTensor's shape propagation at global shapes left out)",
    "cost.bytes_accessed": "each counted op's local operand bytes plus its output bytes, views "
                           "excluded: an unfused upper bound, not a compiler's count",
    "collectives": "every functional collective the step issued, DTensor's implicit "
                   "redistributions included; a Shard-to-Shard redistribution runs as the "
                   "all-to-all a CUDA mesh runs (_dtensor::shard_dim_alltoall)",
    "memory": "argument_bytes: the local shards of the state and inputs the step takes; "
              "alias_bytes: those the step updates in place; peak_bytes_est: MemTracker's peak "
              "of live local bytes",
}
SSD_NOTE = ("ssd_intra ran as ssd_intra_plain (the dry run's tensors are CPU tensors): its "
            "FLOPs and bytes are the plain version's einsums")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _leaves(tree):
    """The tensors of ``tree``: a module's parameters and buffers, and the
    leaves of tuples, lists and dicts (DTensors as they are)."""
    from torch import nn

    if isinstance(tree, nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, Mapping):
        for x in tree.values():
            yield from _leaves(x)


class StepCost(TorchDispatchMode):
    """One device's work in what runs under it: ``flops``, ``bytes_accessed``
    (each op's operand plus output bytes, views excluded) and the
    collectives by kind (``count``, ``operand_bytes``, ``ring_bytes`` under
    :func:`~repro_torch.distributed.collectives.ring_bytes`, over the
    collective's own group).

    An op on DTensors is handed back (``NotImplemented``) so that DTensor
    runs it: its redistributions and its op on the local shards then come
    back here as plain-tensor ops, and those are what is counted. DTensor
    also runs each op once at global shapes to learn the output's shape;
    :func:`propagation_apart` keeps that out of every mode."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.by_kind: dict[str, dict[str, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not isinstance(func, torch._ops.OpOverload):
            return out
        namespace, name = func._schema.name.split("::")
        if namespace == "_c10d_functional" or (namespace, name) == ALLTOALL:
            if name != "wait_tensor":
                self._collective(name, args, out)
            return out
        if func.is_view:
            return out
        from torch.utils.flop_counter import flop_registry

        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        self.bytes_accessed += sum(_nbytes(t) for t in _leaves((args, kwargs, out)))
        return out

    def _collective(self, name: str, args, out) -> None:
        kind = COLLECTIVE_KINDS.get(name)
        if kind is None:
            raise ValueError(f"StepCost: collective {name!r} has no kind; known: "
                             f"{sorted(COLLECTIVE_KINDS)}")
        from torch.distributed.distributed_c10d import _resolve_process_group

        # the group's size is an argument of these two; the others name the group
        # (shard_dim_alltoall's args[3], as all_to_all_single's)
        if kind in ("all-gather", "reduce-scatter"):
            q = int(args[1] if kind == "all-gather" else args[2])
        else:
            q = _resolve_process_group(args[2] if kind == "all-reduce" else args[3]).size()
        operand = sum(_nbytes(t) for t in _leaves(args[0]))
        output = sum(_nbytes(t) for t in _leaves(out))
        d = self.by_kind.setdefault(kind, {"count": 0, "operand_bytes": 0, "ring_bytes": 0})
        d["count"] += 1
        d["operand_bytes"] += operand
        d["ring_bytes"] += ring_bytes(kind, operand, output, q)

    def collectives(self) -> dict:
        """The record's ``collectives``: totals and ``by_kind``."""
        return {
            "operand_bytes": sum(d["operand_bytes"] for d in self.by_kind.values()),
            "ring_bytes": sum(d["ring_bytes"] for d in self.by_kind.values()),
            "by_kind": {k: dict(v) for k, v in self.by_kind.items()},
            "count": sum(d["count"] for d in self.by_kind.values()),
        }


@contextlib.contextmanager
def propagation_apart():
    """DTensor's metadata computations run apart from every dispatch mode.

    To learn an op's output shape, DTensor runs the op on fake tensors of
    the GLOBAL shapes, under the fake mode it finds active; under the dry
    run's that would reach :class:`StepCost` and ``MemTracker`` as if one
    device ran it at full size. Here it runs under a fake mode of its own
    with the other modes set aside, seen by none of them. And to place a
    strided shard (a (batch, sequence) flattened with the sequence split)
    DTensor reads index tensors back as Python ints, which no fake tensor
    can give: those indices are computed with the modes set aside, on real
    index tensors (where this torch has strided shards)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    patched = []

    def patch(owner, name, own, apart):
        setattr(owner, name, apart)
        patched.append((owner, name, own))

    name = "_propagate_tensor_meta_non_cached"
    meta = ShardingPropagator.__dict__.get(name)
    if meta is None:
        raise RuntimeError(f"this torch's DTensor has no ShardingPropagator.{name}: the dry run "
                           f"cannot tell its shape propagation from the local ops")

    def meta_apart(self, op_schema):
        with _disable_current_modes(), FakeTensorMode():
            return meta(self, op_schema)

    strided = getattr(placement_types, "_StridedShard", None)
    offsets = None if strided is None else strided.__dict__.get("local_shard_size_and_offset")

    def offsets_apart(*args, **kwargs):
        with _disable_current_modes():
            return offsets.__get__(None, strided)(*args, **kwargs) if isinstance(
                offsets, staticmethod) else offsets(*args, **kwargs)

    try:
        patch(ShardingPropagator, name, meta, meta_apart)
        if offsets is not None:
            patch(strided, "local_shard_size_and_offset", offsets,
                  staticmethod(offsets_apart) if isinstance(offsets, staticmethod)
                  else offsets_apart)
        yield
    finally:
        for owner, attr, own in patched:
            setattr(owner, attr, own)


@contextlib.contextmanager
def alltoall_as_on_card():
    """A Shard-to-Shard redistribution runs as the all-to-all the card sends.

    DTensor's ``Shard`` placement moves a shard to another dimension with
    ``shard_dim_alltoall``, which on a mesh whose device type is ``"cpu"``
    gathers the whole dimension and keeps a chunk (gloo has no all-to-all)
    and on a CUDA mesh calls the op ``_dtensor::shard_dim_alltoall``. The dry
    run's mesh is a CPU mesh over the ``fake`` group: here it takes the CUDA
    branch, so :class:`StepCost` counts an all-to-all and ``MemTracker``
    sees no gathered temporary. DTensor's padding of uneven shards around
    the call stays as it is. For the ``fake`` group only; a torch without
    the op or without the name replaced is refused, never counted as the
    gather."""
    import torch.distributed as dist
    from torch.distributed.tensor import _collective_utils, placement_types

    if not dist.is_initialized() or dist.get_backend() != "fake":
        raise RuntimeError("alltoall_as_on_card: the dry run's all-to-all stands in for the "
                           "card's on a process group of the fake backend only")
    namespace, name = ALLTOALL
    op = getattr(getattr(torch.ops, namespace), name, None)
    if op is None:
        raise RuntimeError(f"this torch has no op {namespace}::{name}: the dry run cannot count "
                           f"a Shard-to-Shard redistribution as the card's all-to-all")
    if name not in placement_types.__dict__:
        raise RuntimeError(f"this torch's torch.distributed.tensor.placement_types has no "
                           f"{name}: the dry run cannot route a Shard-to-Shard redistribution "
                           f"to the card's all-to-all")

    def on_card(input, gather_dim, shard_dim, mesh, mesh_dim):
        return op(input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    # the name Shard calls, and the one it was imported from
    own = [(m, m.__dict__[name]) for m in (placement_types, _collective_utils)
           if name in m.__dict__]
    try:
        for m, _ in own:
            setattr(m, name, on_card)
        yield
    finally:
        for m, fn in own:
            setattr(m, name, fn)


def _local(x: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return x._local_tensor if isinstance(x, DTensor) else x


def local_bytes(tree) -> int:
    """The bytes of rank 0's shards of every tensor in ``tree``."""
    return sum(_nbytes(_local(x)) for x in _leaves(tree))


def _storages(tree) -> set:
    return {_local(x).untyped_storage()._cdata for x in _leaves(tree)}


def _alias_bytes(args, outputs) -> int:
    """The bytes of the argument leaves whose storage an output reuses: the
    state the step updates in place."""
    reused = _storages(outputs)
    return sum(_nbytes(_local(x)) for x in _leaves(args)
               if _local(x).untyped_storage()._cdata in reused)


def _open_fake_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run opens a fake process group of its own; one is already "
                           "initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             mb_override: int | None = None, policy_overrides: dict | None = None,
             layers: int | None = None) -> dict:
    """Dry-run one cell and write its record to ``out_dir``. ``layers``
    cuts the depth (the encoder-decoder model's decoder too), for tests:
    the record then says so (``n_layers``), counts the cut model and goes
    to a file of its own (``<cell>__<n>L.json``), which :func:`sweep`
    never takes for the full cell's."""
    import torch.distributed as dist

    from ..configs import cell_is_skipped, get_config
    from ..models.config import SHAPES
    from ..models.sharding import make_policy
    from .mesh import dp_axes, make_production_mesh

    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{layers}L" if layers else "")
    out_path = os.path.join(out_dir, f"{cell_id}.json")
    os.makedirs(out_dir, exist_ok=True)

    record: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "devices": 512 if multi_pod else 256,
    }
    skip = cell_is_skipped(arch, shape_name)
    if skip:
        record.update(status="skipped", reason=skip)
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1)
        print(f"SKIP {cell_id}: {skip}")
        return record

    cfg = get_config(arch)
    if os.environ.get("REPRO_SSM_CHUNK"):
        cfg = dataclasses.replace(cfg, ssm_chunk=int(os.environ["REPRO_SSM_CHUNK"]))
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers,
                                  dec_layers=min(cfg.dec_layers, layers))
        record.update(n_layers=cfg.n_layers, dec_layers=cfg.dec_layers)
    shape = SHAPES[shape_name]
    _open_fake_group(record["devices"])
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        sh = make_policy(cfg, mesh, dp=dp_axes(multi_pod))
        if policy_overrides:
            coerced = {}
            for k, v in policy_overrides.items():
                if v in ("0", "1", "true", "false", "True", "False"):
                    v = v in ("1", "true", "True")
                coerced[k] = v
            sh = dataclasses.replace(sh, **coerced)
        dp_size = sh.dp_size
        if shape.global_batch % dp_size:
            sh = dataclasses.replace(sh, shard_batch=False)
        record.update(
            attn_policy=sh.attn, moe_policy=sh.moe,
            shard_batch=sh.shard_batch,
            params=cfg.param_count(),
            active_params=cfg.active_param_count(),
        )
        if shape.kind == "train":
            mb = mb_override or pick_microbatches(arch, shape.global_batch, dp_size)
            record.update(microbatches=mb, bf16_opt=arch in BF16_OPT_ARCHS)
            record["model_flops"] = 6 * cfg.active_param_count() * shape.global_batch * shape.seq_len
        elif shape.kind == "prefill":
            record["model_flops"] = 2 * cfg.active_param_count() * shape.global_batch * shape.seq_len
        else:
            record["model_flops"] = 2 * cfg.active_param_count() * shape.global_batch
        record.update(_measure(cfg, shape, sh, record.get("microbatches", 1),
                               record.get("bf16_opt", False)))
        record["notes"] = dict(NOTES)
        if cfg.family in ("ssm", "hybrid") and shape.kind != "decode":
            record["notes"]["ssd_intra"] = SSD_NOTE
        record["torch"] = torch.__version__
        record["status"] = "ok"
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    mem_gb = record["memory"]["peak_bytes_est"] / 2 ** 30
    print(f"OK {cell_id}: trace={record['trace_s']}s mem/dev={mem_gb:.2f}GiB "
          f"flops={record['cost']['flops']:.3g} coll={record['collectives']['count']}")
    return record


def _measure(cfg, shape, sh, microbatches: int, bf16_opt: bool) -> dict:
    """Build the cell's state and inputs as fake tensors laid out on the
    mesh, run its step once under :class:`StepCost` and ``MemTracker``,
    and return the record's ``trace_s``, ``memory``, ``cost`` and
    ``collectives``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    from ..models import init_decode_state, init_params
    from ..models.model import cache_specs, forward, param_specs
    from ..models.sharding import distribute_tree
    from ..training.steps import (
        batch_specs,
        init_train_state,
        jit_serve_step,
        jit_train_step,
        train_state_specs,
    )
    from .specs import batch_struct, cross_kv_struct, decode_token_struct

    def fake(struct: torch.Tensor) -> torch.Tensor:
        return torch.zeros(struct.shape, dtype=struct.dtype)

    gen = torch.Generator()
    with FakeTensorMode():
        if shape.kind == "train":
            half = torch.bfloat16 if bf16_opt else torch.float32
            state = init_train_state(cfg, generator=gen, device="cpu", moment_dtype=half)
            state = distribute_tree(state, train_state_specs(state, cfg, sh), sh)
            batch = {k: fake(v) for k, v in batch_struct(cfg, shape).items()}
            args = (state, distribute_tree(batch, batch_specs(cfg, sh), sh))
            step = jit_train_step(cfg, sh, state, microbatches=microbatches, accum_dtype=half,
                                  opt_math_dtype=half)
        elif shape.kind == "prefill":
            params = init_params(cfg, generator=gen, device="cpu")
            params = distribute_tree(params, param_specs(params, cfg, sh), sh)
            batch = {k: fake(v) for k, v in batch_struct(cfg, shape).items()}
            args = (params, distribute_tree(batch, batch_specs(cfg, sh), sh))

            def step(params, batch):
                out, _ = forward(params, cfg, batch, mode="prefill", logits_positions="last",
                                 sh=sh)
                return out
        else:
            params = init_params(cfg, generator=gen, device="cpu")
            state = init_decode_state(params, cfg, shape.global_batch, shape.seq_len)
            step = jit_serve_step(cfg, sh, params, state)
            tokens = sh.constrain(fake(decode_token_struct(cfg, shape)), "dp", None)
            args = (distribute_tree(params, param_specs(params, cfg, sh), sh),
                    distribute_tree(state, cache_specs(state, cfg, sh), sh), tokens)
            if cfg.is_encdec:
                args += (tuple(sh.constrain(fake(s), "dp", "sp", None, None)
                               for s in cross_kv_struct(cfg, shape)),)
        tracker = MemTracker()
        tracker.track_external(*_leaves(args))
        cost = StepCost()
        t0 = time.time()
        with propagation_apart(), alltoall_as_on_card(), tracker, cost:
            outputs = step(*args)
        trace_s = round(time.time() - t0, 2)
        memory = {
            "argument_bytes": local_bytes(args),
            "output_bytes": local_bytes(outputs),
            "alias_bytes": _alias_bytes(args, outputs),
            "peak_bytes_est": max(snap["Total"]
                                  for snap in tracker.get_tracker_snapshot("peak").values()),
        }
    return {
        "trace_s": trace_s,
        "memory": memory,
        "cost": {"flops": cost.flops, "bytes_accessed": cost.bytes_accessed},
        "collectives": cost.collectives(),
    }


# ---------------------------------------------------------------------------
# sweep driver (subprocess per cell)
# ---------------------------------------------------------------------------

def sweep(out_dir: str, force: bool = False, multipod_only: bool = False, cells=None):
    from ..configs import all_cells

    todo = cells or [(a, s) for a, s, _ in all_cells()]
    results = []
    for multi_pod in ([True] if multipod_only else [False, True]):
        mesh_name = "2x16x16" if multi_pod else "16x16"
        for arch, shape_name in todo:
            out_path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
            if not force and os.path.exists(out_path):
                with open(out_path) as f:
                    rec = json.load(f)
                if rec.get("status") in ("ok", "skipped"):
                    print(f"CACHED {arch}__{shape_name}__{mesh_name}")
                    results.append(rec)
                    continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name, "--out", out_dir]
            if multi_pod:
                cmd.append("--multipod")
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
            if proc.returncode != 0:
                err = {
                    "arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "status": "error",
                    "stderr": proc.stderr[-4000:],
                }
                with open(out_path, "w") as f:
                    json.dump(err, f, indent=1)
                print(f"ERROR {arch}__{shape_name}__{mesh_name}")
                print(proc.stderr[-1500:])
                results.append(err)
            else:
                print(proc.stdout.strip().splitlines()[-1])
                with open(out_path) as f:
                    results.append(json.load(f))
    ok = sum(1 for r in results if r.get("status") == "ok")
    sk = sum(1 for r in results if r.get("status") == "skipped")
    er = sum(1 for r in results if r.get("status") == "error")
    print(f"\nsweep done: {ok} ok, {sk} skipped, {er} error")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--mb", type=int, default=None, help="override train microbatch count")
    ap.add_argument("--policy", action="append", default=[],
                    help="Sharding field override key=val (hillclimb)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=os.path.normpath(RESULTS_DIR))
    args = ap.parse_args(argv)
    if args.all:
        sweep(args.out, force=args.force)
    else:
        try:
            run_cell(args.arch, args.shape, args.multipod, args.out, mb_override=args.mb,
                     policy_overrides=dict(kv.split("=", 1) for kv in args.policy))
        except Exception:
            traceback.print_exc()
            sys.exit(1)


if __name__ == "__main__":
    main()
