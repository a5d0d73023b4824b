#!/usr/bin/env python3
"""The split-K reduction's device time at the workspaces the main paths give it.

    python3 scripts/probe_splitk.py [--seed N] [--baseline PATH/mttkrp.cu]

Needs one CUDA card and nvcc. ``splitk_reduce`` (``csrc/mttkrp.cu``) sums an
fp32 ``(S, I, R)`` workspace over its slabs. The workspaces are those the
planners give on a 132-SM card: the MTTKRP kernel and the fused pair at
1000^3, R=64 (33 slabs) and 180^4, R=32 (132 slabs), Multi-TTM at 180^4,
ranks 16 (2 slabs of 180 x 4096), and the dimension tree's partial
contractions ((1000, 1000) and (180, 180) nodes: 2 and 3 slabs).

At each workspace it times, as device time by CUDA graphs
(``chip_smoke.graph_ms``: 50 launches captured in one graph, replayed four
times between CUDA events, so no host time falls between launches):

* ``this``: this checkout's kernel;
* ``baseline`` (with ``--baseline``): another version of ``mttkrp.cu`` with
  the same C interface, say an unpacked earlier commit's, built against its
  own headers;
* ``torch.sum(ws, 0)``, the library call for the same function.

Three rounds in the order baseline, this, this, baseline, ``torch.sum``;
each line carries every reading and the means. Every version is first
checked bit for bit against the in-order slab sum. JSON lines, with the
card's name and power limit. The libraries are written under
``src/repro_torch/kernels/_build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (S, I, R) by where the main paths launch it, as the planners give it on 132 SMs
WORKSPACES = {
    "mttkrp/fused_pair 1000^3 R=64": (33, 1000, 64),
    "mttkrp/fused_pair 180^4 R=32": (132, 180, 32),
    "multi_ttm_keep 180^4 ranks 16": (2, 180, 4096),
    "mttkrp_partial (1000, 1000) R=64": (2, 1000, 64),
    "mttkrp_partial (180, 180) R=32": (3, 180, 32),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", metavar="MTTKRP_CU",
                    help="another mttkrp.cu to time against this checkout's")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_splitk: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from chip_smoke import graph_ms, nvidia_smi
    from repro_torch.analysis.roofline import H100
    from repro_torch.kernels import build, splitk

    gpu = nvidia_smi()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    builds = {"this": (build.CSRC / "mttkrp.cu", [])}
    if args.baseline:  # its own directory first, for its own headers
        base = os.path.abspath(args.baseline)
        builds["baseline"] = (base, ["-I", os.path.dirname(base)])

    def compile_one(item):
        name, (source, flags) = item
        out = build.BUILD_DIR / f"probe_splitk_{name}.so"
        subprocess.run([build.nvcc_path(), *flags, *build.NVCC_FLAGS, "-o", str(out),
                        str(source)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(out))
        for fn, (restype, argtypes) in build.SIGNATURES["mttkrp.cu"].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        return name, lib

    with ThreadPoolExecutor(len(builds)) as ex:  # one nvcc per version, all at once
        libs = dict(ex.map(compile_one, builds.items()))

    def reduce_with(name, ws, out):
        splitk.library = lambda: libs[name]  # the wrapper, pointed at this version
        return lambda: splitk.splitk_reduce(ws, out)

    names = (["baseline"] if args.baseline else []) + ["this"]
    order = names + names[::-1]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for where, (s, i, r) in WORKSPACES.items():
        ws = torch.randn((s, i, r), generator=gen, device="cuda")
        out = torch.empty((i, r), device="cuda")
        in_order = torch.zeros_like(out)
        for slab in ws:
            in_order += slab
        for name in names:
            reduce_with(name, ws, out)()
            if not torch.equal(out, in_order):
                raise AssertionError(f"{name} at {where}: not the in-order slab sum's bits")
        ms = {name: [] for name in names}
        lib_ms = []
        for _ in range(3):
            for name in order:
                ms[name].append(graph_ms(reduce_with(name, ws, out)))
            lib_ms.append(graph_ms(lambda: torch.sum(ws, 0)))
        mean = {name: sum(t) / len(t) for name, t in ms.items()}
        bound_ms = (s + 1) * i * r * 4 / H100.hbm_bw * 1e3
        print(json.dumps({"probe": "splitk", "where": where, "workspace": [s, i, r],
                          "order": order, "graph_ms": ms, "mean_ms": mean,
                          "torch_sum_ms": lib_ms, "torch_sum_mean_ms": sum(lib_ms) / 3,
                          "bound_ms": bound_ms, "baseline_source": args.baseline,
                          "gpu": gpu}), flush=True)
        del ws, out, in_order
    return 0


if __name__ == "__main__":
    sys.exit(main())
