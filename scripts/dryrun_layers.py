#!/usr/bin/env python3
"""The dry run's costs at a cut depth, on the host CPU (no card needed).

    python3 scripts/dryrun_layers.py sweep [ARCH SHAPE ...] [--src TREE/src] [--reference]
        [--multipod] [--layers 1] [--procs 4] [--out F]
    python3 scripts/dryrun_layers.py compare OLD NEW
    python3 scripts/dryrun_layers.py sites ARCH SHAPE [--src TREE/src] [--layers 1] [--min-gb 0.1]
        [--flops | --peak]

``sweep`` runs ``repro_torch.launch.dryrun.run_cell(arch, shape, False,
layers=N)`` for each (arch, shape) cell given, or every cell of the 16x16
mesh (``--multipod``: of the 2x16x16 mesh, whose cells take several times
as long), each in a subprocess of its own, ``--procs`` at once, on the
``repro_torch`` of ``--src`` (default this checkout's; an unpacked earlier
commit's for a comparison), and prints one JSON line a cell: its status,
FLOPs, ring bytes, peak and collectives by kind. With ``--reference`` it
runs the JAX reference's cell instead, cut to the same depth by
``tests/test_torch_dryrun_reference.py``'s ``_start`` (this checkout's
``src/repro``), and prints its status, FLOPs, ring bytes and peak.
``--out`` also writes the lines to a file. ``compare OLD NEW`` reads two
such files and prints, for each cell, the three numbers' ratios, and the
cells where NEW reads more ring bytes or FLOPs than OLD, or peaks more
than 1 % above it (exit 1 if any); with the reference's as OLD the ratios
are the port's multiples of the reference's.

``sites`` runs one cell and attributes each collective to a call site:
in the forward the innermost frames of ``repro_torch`` outside the
sharding layer, in the backward the forward frames of the autograd node
that ran it (recorded under ``torch.autograd.detect_anomaly``). One line
a site, heaviest first: ring GB, count, kind, site and the operands'
local shapes and dtype. Under activation checkpointing the recomputed
forward runs inside the backward: its ops go to the backward node that
first unpacks a saved tensor. With ``--flops`` it attributes one device's
FLOPs instead, op by op as the record counts them, to the same call
sites: TFLOP, count, op, site and the operands' local shapes (a product's
``(m, k) @ (k, n)``), each site of at least 100 GFLOP.

With ``--peak`` it lists one device's live local bytes at the moment of
``MemTracker``'s peak (the record's ``peak_bytes_est``), grouped by the
call site that allocated each storage (the same frames; a recomputed
forward's on its backward node; the step's state and inputs as
"argument") and the tensor's local shape and dtype: GB, count, site and
shape, each group of at least ``--min-gb``, then the rest in one line.
The first line's ``live_bytes_at_peak`` sums every group: it equals
``peak_bytes_est`` (a storage resized in place counts at its new size
from then on).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import traceback
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: One cell at a cut depth, its numbers printed as the last line.
CELL = r"""
import json, sys
from repro_torch.launch import dryrun
rec = dryrun.run_cell(sys.argv[1], sys.argv[2], sys.argv[5] == "1", sys.argv[3],
                      layers=int(sys.argv[4]))
out = {"arch": sys.argv[1], "shape": sys.argv[2], "status": rec["status"]}
if rec["status"] == "ok":
    out.update(flops=rec["cost"]["flops"], ring_bytes=rec["collectives"]["ring_bytes"],
               peak_bytes_est=rec["memory"]["peak_bytes_est"],
               by_kind=rec["collectives"]["by_kind"], trace_s=rec["trace_s"])
print(json.dumps(out))
"""


def _cells() -> list[tuple[str, str]]:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import all_cells

    return [(a, s) for a, s, _ in all_cells()]


#: A site's least FLOPs for ``sites --flops`` to print it.
MIN_FLOPS = 100e9


def _run(src: str, multi_pod: bool, arch: str, shape: str, layers: int) -> dict:
    env = {**os.environ, "PYTHONPATH": src}
    with tempfile.TemporaryDirectory() as out:
        proc = subprocess.run([sys.executable, "-c", CELL, arch, shape, out, str(layers),
                               str(int(multi_pod))],
                              env=env, capture_output=True, text=True, timeout=1800)
    if proc.returncode:
        return {"arch": arch, "shape": shape, "status": "error", "stderr": proc.stderr[-2000:]}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _reference():
    """``tests/test_torch_dryrun_reference.py``, whose ``_start`` runs the
    reference's cell at a cut depth."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    path = os.path.join(ROOT, "tests", "test_torch_dryrun_reference.py")
    spec = importlib.util.spec_from_file_location("dryrun_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_reference(ref, arch: str, shape: str, layers: int) -> dict:
    with tempfile.TemporaryDirectory() as out:
        proc = ref._start(arch, shape, layers, out)
        stdout, err = proc.communicate(timeout=1800)
    if proc.returncode:
        return {"arch": arch, "shape": shape, "status": "error", "stderr": err[-2000:]}
    rec = json.loads(stdout.strip().splitlines()[-1])
    line = {"arch": arch, "shape": shape, "status": rec["status"]}
    if rec["status"] == "ok":
        line.update({k: ref._number(rec, k) for k in ("flops", "ring_bytes", "peak_bytes_est")})
    return line


def sweep(src: str, cells: list[tuple[str, str]], layers: int, procs: int, out: str | None,
          reference: bool = False, multi_pod: bool = False) -> None:
    if reference:
        if multi_pod:
            raise ValueError("sweep: the reference's cells run on the 16x16 mesh only")
        ref = _reference()
        run = functools.partial(_run_reference, ref)
    else:
        run = functools.partial(_run, src, multi_pod)
    lines = []
    with ThreadPoolExecutor(procs) as pool:
        for rec in pool.map(lambda c: run(*c, layers), cells or _cells()):
            line = json.dumps(rec)
            print(line, flush=True)
            lines.append(line)
    if out:
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")


def compare(old_path: str, new_path: str) -> int:
    def load(path):
        with open(path) as f:
            return {(r["arch"], r["shape"]): r for r in map(json.loads, f) if r}

    old, new = load(old_path), load(new_path)
    worse = []
    for cell, n in new.items():
        o = old.get(cell)
        if o is None or "flops" not in o or "flops" not in n:
            print(json.dumps({"cell": cell, "old": o and o["status"], "new": n["status"]}))
            continue
        ratio = {k: n[k] / o[k] if o[k] else None
                 for k in ("flops", "ring_bytes", "peak_bytes_est")}
        print(json.dumps({"cell": " ".join(cell), **ratio}))
        if (n["flops"] > o["flops"] or n["ring_bytes"] > o["ring_bytes"]
                or n["peak_bytes_est"] > 1.01 * o["peak_bytes_est"]):
            worse.append(" ".join(cell))
    print(json.dumps({"cells": len(new), "worse": worse}))
    return 1 if worse else 0


def _frames(lines) -> list[str]:
    """The innermost three frames of ``repro_torch`` outside the sharding
    layer and the dry run, innermost first."""
    out = []
    for f in lines:
        if "repro_torch/" in f.filename and not f.filename.endswith(("sharding.py", "dryrun.py")):
            out.append(f"{f.filename.split('repro_torch/')[1]}:{f.lineno} {f.name}")
    return out[::-1][:3]


def _site() -> str:
    """Where the op running now was called: its forward frames, or in the
    backward the autograd node's name and the forward frames that made it
    (recorded under ``torch.autograd.detect_anomaly``)."""
    import torch

    node = torch._C._current_autograd_node()
    if node is None:
        return "forward " + " < ".join(_frames(traceback.extract_stack()))
    tb = node.metadata.get("traceback_") or []
    stack = traceback.StackSummary.from_list([])
    for text in (tb if isinstance(tb, list) else [tb]):
        for line in str(text).splitlines():
            line = line.strip()
            if line.startswith('File "') and ", line " in line:
                name, rest = line[6:].split('", line ', 1)
                lineno, _, fn = rest.partition(", in ")
                stack.append(traceback.FrameSummary(name, int(lineno), fn))
    return f"backward {node.name()} " + " < ".join(_frames(stack))


class _PeakWatch:
    """``MemTracker``'s storages, each with the call site and the shape and
    dtype of the tensor that brought it, and the moment of the tracker's
    peak: :meth:`live` is what was live then. Patches the class while
    entered (every tracker made meanwhile is watched)."""

    ARGUMENT = "argument (the step's state and inputs)"

    def __init__(self):
        self.t = 0
        self.born: dict[int, tuple] = {}
        self.dead: dict[int, int] = {}
        self.peak, self.peak_t = -1, 0
        self.pending = None  # where the storage being added came from

    def __enter__(self):
        from torch.distributed._tools.mem_tracker import MemTracker, _UpdateType

        watch, arguments = self, []
        self.patched = own = {n: getattr(MemTracker, n) for n in (
            "track_external", "_track", "_update_and_maybe_create_winfos", "_update_snap",
            "_update_peak_stats")}

        def label(t) -> str:
            t = getattr(t, "_local_tensor", t)  # a DTensor's local shard
            return f"{tuple(t.shape)} {str(t.dtype).removeprefix('torch.')}"

        def track_external(tracker, *external):
            arguments.append(True)
            try:
                own["track_external"](tracker, *external)
            finally:
                arguments.pop()

        def tracking(name):
            def run(tracker, *args, **kwargs):
                t = args[1] if name == "_track" else args[0]
                watch.pending = lambda: (watch.ARGUMENT if arguments else _site(), label(t))
                try:
                    return own[name](tracker, *args, **kwargs)
                finally:
                    watch.pending = None
            return run

        def update_snap(tracker, u_type, winfo, *args, **kwargs):
            # each storage the tracker adds comes through _track or
            # _update_and_maybe_create_winfos, which say where it came from;
            # a resize ends one life of a storage and starts another
            own["_update_snap"](tracker, u_type, winfo, *args, **kwargs)
            if u_type in (_UpdateType.DEL, _UpdateType.SIZE):
                watch.dead[winfo._watch] = watch.t
                watch.t += 1
            if u_type in (_UpdateType.ADD, _UpdateType.SIZE):
                where = watch.pending() if u_type == _UpdateType.ADD else watch.born[
                    winfo._watch][2]
                winfo._watch = len(watch.born)
                watch.born[winfo._watch] = (watch.t, winfo.mem_consumed, where)
                watch.t += 1

        def update_peak(tracker, peak_state):
            own["_update_peak_stats"](tracker, peak_state)
            peak = max(tracker._peak_mem.values(), default=0)
            if peak > watch.peak:
                watch.peak, watch.peak_t = peak, watch.t

        for name, fn in (("track_external", track_external), ("_track", tracking("_track")),
                         ("_update_and_maybe_create_winfos",
                          tracking("_update_and_maybe_create_winfos")),
                         ("_update_snap", update_snap), ("_update_peak_stats", update_peak)):
            setattr(MemTracker, name, fn)
        return self

    def __exit__(self, *exc):
        from torch.distributed._tools.mem_tracker import MemTracker

        for name, fn in self.patched.items():
            setattr(MemTracker, name, fn)

    def live(self) -> dict:
        """``(site, shape and dtype)`` -> [count, bytes] of the storages
        live at the peak."""
        out: dict = collections.defaultdict(lambda: [0, 0])
        for serial, (t, nbytes, where) in self.born.items():
            if t < self.peak_t and self.dead.get(serial, self.peak_t) >= self.peak_t:
                out[where][0] += 1
                out[where][1] += nbytes
        return dict(out)


def sites(src: str, arch: str, shape: str, layers: int, min_gb: float,
          flops: bool = False, peak: bool = False) -> dict:
    """Run the cell and print its attribution (see the module's
    docstring); return its record's numbers and the rows, ``(what, site,
    shapes)`` -> [count, amount], heaviest first."""
    sys.path.insert(0, src)
    import torch

    from repro_torch.launch import dryrun

    totals: dict = collections.defaultdict(lambda: [0, 0])
    own, own_dispatch = dryrun.StepCost._collective, dryrun.StepCost.__torch_dispatch__

    def counted(self, name, args, out):
        before = sum(d["ring_bytes"] for d in self.by_kind.values())
        own(self, name, args, out)
        ring = sum(d["ring_bytes"] for d in self.by_kind.values()) - before
        shapes = ",".join(f"{tuple(t.shape)} {str(t.dtype)[6:]}" for t in dryrun._leaves(args[0]))
        entry = totals[(dryrun.COLLECTIVE_KINDS[name], _site(), shapes)]
        entry[0] += 1
        entry[1] += ring

    def dispatched(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = own_dispatch(self, func, types, args, kwargs)
        if self.flops != before:
            shapes = " @ ".join(str(tuple(t.shape)) for t in dryrun._leaves(args)
                                if isinstance(t, torch.Tensor) and t.ndim)
            entry = totals[(func._overloadpacket.__name__, _site(), shapes)]
            entry[0] += 1
            entry[1] += self.flops - before
        return out

    watch = _PeakWatch()
    if flops:
        dryrun.StepCost.__torch_dispatch__ = dispatched
    elif not peak:
        dryrun.StepCost._collective = counted
    try:
        with (tempfile.TemporaryDirectory() as out, torch.autograd.detect_anomaly(check_nan=False),
              watch if peak else contextlib.nullcontext()):
            rec = dryrun.run_cell(arch, shape, False, out, layers=layers)
    finally:
        dryrun.StepCost._collective, dryrun.StepCost.__torch_dispatch__ = own, own_dispatch
    head = {"arch": arch, "shape": shape, "layers": layers, "flops": rec["cost"]["flops"],
            "ring_bytes": rec["collectives"]["ring_bytes"],
            "peak_bytes_est": rec["memory"]["peak_bytes_est"]}
    if peak:
        totals = {("live", where, shapes): v for (where, shapes), v in watch.live().items()}
        head["live_bytes_at_peak"] = sum(n for _, n in totals.values())
    print(json.dumps(head))
    unit, least = (1e12, MIN_FLOPS) if flops else (1e9, min_gb * 1e9)
    rows = dict(sorted(totals.items(), key=lambda kv: -kv[1][1]))
    for (kind, where, shapes), (count, n) in rows.items():
        if n >= least:
            print(f"{n / unit:9.3f} {'TFLOP' if flops else 'GB'} {count:5d} {kind:15s} {where}"
                  f"  [{shapes}]")
    if peak:
        rest = [n for _, n in rows.values() if n < least]
        print(f"{sum(rest) / unit:9.3f} GB {len(rest):5d} live            the rest, each site "
              f"under {min_gb} GB")
    return {**head, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("sweep", "sites", "compare"))
    ap.add_argument("args", nargs="*",
                    help="sweep: ARCH SHAPE pairs; sites: ARCH SHAPE; compare: OLD NEW")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--out")
    ap.add_argument("--min-gb", type=float, default=0.1)
    ap.add_argument("--flops", action="store_true", help="sites: attribute FLOPs, not bytes")
    ap.add_argument("--peak", action="store_true",
                    help="sites: attribute the live bytes at the peak, not bytes sent")
    ap.add_argument("--reference", action="store_true", help="sweep: the JAX reference's cells")
    ap.add_argument("--multipod", action="store_true", help="sweep: the 2x16x16 mesh's cells")
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    if args.what == "sweep":
        cells = list(zip(args.args[::2], args.args[1::2]))
        sweep(src, cells, args.layers, args.procs, args.out, args.reference, args.multipod)
    elif args.what == "compare":
        return compare(*args.args)
    else:
        sites(src, *args.args, args.layers, args.min_gb, args.flops, args.peak)
    return 0


if __name__ == "__main__":
    sys.exit(main())
