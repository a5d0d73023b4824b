#!/usr/bin/env python3
"""Where a chunk of the Hopper MTTKRP kernel spends its time.

    python3 scripts/probe_mttkrp.py [--seed N] [--baseline PATH/mttkrp.cu]

Needs one CUDA card and nvcc. Two measurements, printed as JSON lines:

* ``plan``: the kernel's time at 1000^3, R=64 and 180^4, R=32, fp32 and
  bf16 X, under a sweep of pinned plans (``block_i`` 64 and 128, chunks of
  64, 128 and 256 bytes a row, 2 to 4 stages), beside the plan
  ``choose_mttkrp_kernel_blocks`` gives;
* ``phase``: the default plan's launch with one phase of each chunk's loop
  compiled out (the ring copies of a later chunk, or the MMA with the
  prefix scaling, or both), at the same shapes. The variants compute wrong results on
  purpose: the difference to the full kernel is the time that phase costs
  when the others still run. The variant sources and libraries are written
  under ``src/repro_torch/kernels/_build/``.

With ``--baseline``, only a third: ``baseline``, this checkout's default
plan at the same shapes and the dimension tree's 2-D edge ((10^6, 1000),
R=64, fp32), timed with this checkout's kernel and with another version of
``mttkrp.cu`` of the same C interface (say, from an unpacked parent commit,
built against its own headers), three times in the order baseline, this,
this, baseline on the same inputs, and the mean of each.

Times are CUDA-event means over 5 launches after 2 warm-ups (20 for
``baseline``).
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
    "ring_copies": ("SKIP_COPY", "// ring copies:"),
    "mma": ("SKIP_MMA", "// MMA:"),
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


def probe_source(src: str, phases: dict = PHASES) -> str:
    """The kernel source with each phase of ``phases`` (name -> (macro,
    marker comment[, stand-ins])) wrapped in ``#ifndef <macro>``, at every
    line that carries the marker (a kernel with an fp32 and a bf16 branch
    has one block of each). Stand-ins, one a block, go under ``#else``: code
    that keeps what the block read alive, so the compiler does not drop the
    phases before it."""
    lines = src.split("\n")
    inserts = []
    for macro, marker, *rest in phases.values():
        starts = [i for i, line in enumerate(lines) if marker in line]
        if not starts:
            raise ValueError(f"no {marker!r} in the source")
        stand_ins = rest[0] if rest else [None] * len(starts)
        if len(stand_ins) != len(starts):
            raise ValueError(f"{len(starts)} blocks marked {marker!r}, {len(stand_ins)} stand-ins")
        for start, stand_in in zip(starts, stand_ins):
            first_brace = next(i for i in range(start, len(lines))
                               if "{" in lines[i].split("//")[0])
            end = _block_end(lines, first_brace) + 1
            # (line, order among the lines inserted there, text)
            inserts.append((start, 2, f"#ifndef {macro}"))
            if stand_in is not None:
                inserts.append((end, 0, f"#else\n{stand_in}"))
            inserts.append((end, 1, "#endif"))
    for pos, _, text in sorted(inserts, reverse=True):
        lines.insert(pos, text)
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", metavar="MTTKRP_CU",
                    help="another mttkrp.cu to time against this checkout's")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_mttkrp: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from chip_smoke import cuda_ms, nvidia_smi
    from repro_torch.engine.plan import MTTKRPKernelPlan, choose_mttkrp_kernel_blocks
    from repro_torch.kernels import build, splitk

    gpu = nvidia_smi()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "probe_mttkrp.cu"
    src.write_text(probe_source((build.CSRC / "mttkrp.cu").read_text()))
    variants = {"full": (src, [])}
    if args.baseline:  # its own directory first, for its own headers
        base = os.path.abspath(args.baseline)
        variants["baseline"] = (base, ["-I", os.path.dirname(base)])
    else:
        variants.update({f"no_{name}": (src, [f"-D{m}"]) for name, (m, _) in PHASES.items()})
        variants["only_barriers"] = (src, [f"-D{m}" for m, _ in PHASES.values()])

    def compile_one(item):
        name, (source, flags) = item
        out = build.BUILD_DIR / f"probe_{name}.so"
        subprocess.run([build.nvcc_path(), *flags, *build.NVCC_FLAGS, "-o", str(out),
                        str(source)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(out))
        for fn, (restype, argtypes) in build.SIGNATURES["mttkrp.cu"].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        return name, lib

    with ThreadPoolExecutor(len(variants)) as ex:  # one nvcc per variant, all at once
        libs = dict(ex.map(compile_one, variants.items()))

    def timed(lib, x, fs, plan, reps=5):
        splitk.library = lambda: lib  # the launch path, pointed at this variant
        return cuda_ms(lambda: splitk.launch_tile(x, fs, plan, specialized=x.ndim == 3,
                                                  name="probe"), reps=reps)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if args.baseline:
        cases = [((1000, 1000, 1000), 64, torch.float32), ((1000, 1000, 1000), 64, torch.bfloat16),
                 ((180, 180, 180, 180), 32, torch.float32), ((10 ** 6, 1000), 64, torch.float32)]
        for dims, rank, dtype in cases:
            x = torch.randn(dims, generator=gen, device="cuda").to(dtype)
            fs = [torch.randn((d, rank), generator=gen, device="cuda").to(dtype)
                  for d in dims[1:]]
            plan = choose_mttkrp_kernel_blocks(dims, rank, x.element_size())
            order = ["baseline", "full", "full", "baseline"] * 3
            ms = [timed(libs[name], x, fs, plan, reps=20) for name in order]
            mean = {name: sum(t for t, n in zip(ms, order) if n == name) / 6
                    for name in ("baseline", "full")}
            print(json.dumps({"probe": "baseline", "shape": list(dims), "rank": rank,
                              "dtype": str(dtype).split(".")[-1],
                              "plan": [plan.block_i, plan.block_k, plan.block_r, plan.stages],
                              "order": ["baseline", "this", "this", "baseline"] * 3, "ms": ms,
                              "mean_ms": {"baseline": mean["baseline"], "this": mean["full"]},
                              "baseline_source": args.baseline, "gpu": gpu}), flush=True)
            del x, fs
            torch.cuda.empty_cache()
        return 0
    for dims, rank in [((1000, 1000, 1000), 64), ((180, 180, 180, 180), 32)]:
        x32 = torch.randn(dims, generator=gen, device="cuda")
        fs32 = [torch.randn((d, rank), generator=gen, device="cuda") for d in dims[1:]]
        for dtype in (torch.float32, torch.bfloat16):
            x, fs = x32.to(dtype), [f.to(dtype) for f in fs32]
            size = x.element_size()
            main_plan = choose_mttkrp_kernel_blocks(dims, rank, size)
            plans = [main_plan] + [
                MTTKRPKernelPlan(bi, width // size, main_plan.block_r, stages)
                for bi in (64, 128) for width in (64, 128, 256) for stages in (2, 3, 4)]
            for plan in dict.fromkeys(plans):
                smem = splitk.smem_bytes(plan, x.dtype, len(dims) - 1)
                if smem > splitk.SMEM_PER_CTA_MAX:
                    continue
                print(json.dumps({"probe": "plan", "shape": list(dims), "rank": rank,
                                  "dtype": str(dtype).split(".")[-1],
                                  "plan": [plan.block_i, plan.block_k, plan.block_r, plan.stages],
                                  "default": plan == main_plan, "smem_bytes": smem,
                                  "ms": timed(libs["full"], x, fs, plan), "gpu": gpu}),
                      flush=True)
            for name, lib in libs.items():
                print(json.dumps({"probe": "phase", "shape": list(dims), "rank": rank,
                                  "dtype": str(dtype).split(".")[-1],
                                  "plan": [main_plan.block_i, main_plan.block_k,
                                           main_plan.block_r, main_plan.stages],
                                  "variant": name, "ms": timed(lib, x, fs, main_plan),
                                  "gpu": gpu}), flush=True)
            del x, fs
        del x32, fs32
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
