#!/usr/bin/env python3
"""Where a step of the Hopper MTTKRP tile kernel spends its time.

    python3 scripts/probe_mttkrp.py [--seed N]

Needs one CUDA card and nvcc. Two measurements, printed as JSON lines:

* ``plan``: the tile kernel's time at 1000^3, R=64 (fp32) under several
  pinned block plans, beside the plan ``Memory.h100_smem()`` gives;
* ``phase``: the same launch with one phase of each contraction step
  compiled out (factor-tile loads, X-tile loads, the KRP block build, the
  FMA loop, or all four), for the main path's plans at 1000^3, R=64 and
  180^4, R=32. The variants compute wrong results on purpose: the
  difference to the full kernel is the time that phase costs when the
  others still run. The variant sources and libraries are written under
  ``src/repro_torch/kernels/_build/``.

Times are CUDA-event means over 5 launches after 2 warm-ups.
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
PHASES = {  # variant -> (macro, comment line that opens the phase's block)
    "factor_loads": ("SKIP_F", "// factor tiles (fp32), masked"),
    "x_loads": ("SKIP_X", "// X tile, masked"),
    "w_build": ("SKIP_W", "// KRP block:"),
    "compute": ("SKIP_C", "for (int c = c_begin + 4 * cs;"),
}


def _block_end(lines: list[str], i: int) -> int:
    """Index of the line closing the first brace opened at or after line i."""
    depth, started = 0, False
    for j in range(i, len(lines)):
        for ch in lines[j].split("//")[0]:  # braces in comments do not count
            if ch == "{":
                depth, started = depth + 1, True
            elif ch == "}":
                depth -= 1
        if started and depth == 0:
            return j
    raise ValueError("unbalanced braces")


def probe_source(src: str) -> str:
    """The kernel source with each phase wrapped in ``#ifndef SKIP_<phase>``."""
    lines = src.split("\n")
    inserts = []
    for macro, marker in PHASES.values():
        start = next(i for i, line in enumerate(lines) if marker in line)
        first_brace = next(i for i in range(start, len(lines)) if "{" in lines[i].split("//")[0])
        inserts += [(start, f"#ifndef {macro}"), (_block_end(lines, first_brace) + 1, "#endif")]
    for pos, text in sorted(inserts, reverse=True):
        lines.insert(pos, text)
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_mttkrp: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from chip_smoke import cuda_ms, nvidia_smi
    from repro_torch.engine.plan import BlockPlan, Memory, choose_blocks
    from repro_torch.kernels import build, splitk

    gpu = nvidia_smi()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "probe_mttkrp.cu"
    src.write_text(probe_source((build.CSRC / "mttkrp.cu").read_text()))
    variants = {"full": []}
    variants.update({f"no_{name}": [f"-D{m}"] for name, (m, _) in PHASES.items()})
    variants["only_barriers"] = [f"-D{m}" for m, _ in PHASES.values()]

    def compile_one(item):
        name, flags = item
        out = build.BUILD_DIR / f"probe_{name}.so"
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", str(out), str(src)],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(out))
        for fn, (restype, argtypes) in build.SIGNATURES["mttkrp.cu"].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        return name, lib

    with ThreadPoolExecutor(len(variants)) as ex:  # one nvcc per variant, all at once
        libs = dict(ex.map(compile_one, variants.items()))

    def timed(lib, x, fs, plan):
        splitk.library = lambda: lib  # the launch path, pointed at this variant
        return cuda_ms(lambda: splitk.launch_tile(x, fs, plan, specialized=x.ndim == 3,
                                                  name="probe"), reps=5)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for dims, rank in [((1000, 1000, 1000), 64), ((180, 180, 180, 180), 32)]:
        x = torch.randn(dims, generator=gen, device="cuda")
        fs = [torch.randn((d, rank), generator=gen, device="cuda") for d in dims[1:]]
        main_plan = choose_blocks(dims, rank, memory=Memory.h100_smem())
        plans = [main_plan]
        if len(dims) == 3:
            plans += [BlockPlan(16, (8, 64), 32), BlockPlan(32, (8, 32), 32),
                      BlockPlan(64, (4, 32), 64), BlockPlan(128, (4, 16), 64)]
            for plan in plans:
                print(json.dumps({"probe": "plan", "shape": list(dims), "rank": rank,
                                  "plan": [plan.block_i, *plan.block_contract, plan.block_r],
                                  "h100_default": plan == main_plan,
                                  "smem_bytes": splitk.smem_bytes(plan, x.dtype),
                                  "ms": timed(libs["full"], x, fs, plan), "gpu": gpu}),
                      flush=True)
        for plan in (main_plan, plans[-1]) if len(dims) == 3 else (main_plan,):
            for name, lib in libs.items():
                print(json.dumps({"probe": "phase", "shape": list(dims), "rank": rank,
                                  "plan": [plan.block_i, *plan.block_contract, plan.block_r],
                                  "variant": name, "ms": timed(lib, x, fs, plan), "gpu": gpu}),
                      flush=True)
        del x, fs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
