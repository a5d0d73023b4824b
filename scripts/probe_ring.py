#!/usr/bin/env python3
"""Where the fused pair and the Multi-TTM kernels spend their time.

    python3 scripts/probe_ring.py [--seed N]

Needs one CUDA card and nvcc. Both kernels run on the ``cp.async`` ring and
tensor cores of ``csrc/ring.cuh`` (``fused_pair_mma_kernel`` in
``csrc/sweep.cu``, ``multi_ttm_mma_kernel`` in ``csrc/multi_ttm.cu``). Two
measurements, printed as JSON lines:

* ``plan``: each kernel's time under a sweep of pinned plans (64- and
  128-row tiles, and 192 for Multi-TTM, chunks of 64, 128 and 256 bytes a
  row, 2 to 4 stages, where they fit one CTA) beside its default plan: ``fused_pair`` at 1000^3, R=64
  (fp32, bf16) and 180^4, R=32; ``multi_ttm_keep`` at 1000^3, ranks
  (32, 32) (fp32, bf16) and 180^4, ranks (16, 16, 16);
* ``phase``: the default plan's launch with one phase of each chunk's loop
  compiled out (the ring copies of a later chunk, or the MMA, or both, as
  ``scripts/probe_mttkrp.py`` does for the MTTKRP kernel; for the
  Multi-TTM kernel also with its per-tile fold out, and with only the fold
  in), at the same shapes. The variants compute wrong results on purpose:
  the difference to the full kernel is the time that phase costs when the
  others still run; what is left with all out is the barriers, the launch
  and, for the pair, its per-tuple epilogue (the P stores, the B0 update).

Times are CUDA-event means over 5 launches after 2 warm-ups. The variant
sources and libraries are written under ``src/repro_torch/kernels/_build/``.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_ring: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from chip_smoke import cuda_ms, nvidia_smi
    from probe_mttkrp import PHASES, probe_source
    from repro_torch.engine import plan as plans
    from repro_torch.kernels import build
    from repro_torch.kernels import multi_ttm as ttm_mod
    from repro_torch.kernels import sweep as pair_mod

    gpu = nvidia_smi()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # the phases of each source: the Multi-TTM kernel's per-tile fold too
    phases = {"sweep.cu": dict(PHASES),
              "multi_ttm.cu": {**PHASES, "fold": ("SKIP_FOLD", "// fold:")}}
    variants = {}  # (source, variant) -> nvcc flags
    for source, ph in phases.items():
        variants[(source, "full")] = []
        for name, (macro, _) in ph.items():
            variants[(source, f"no_{name}")] = [f"-D{macro}"]
        variants[(source, "only_barriers")] = [f"-D{m}" for m, _ in ph.values()]
    variants[("multi_ttm.cu", "only_fold")] = [f"-D{m}" for m, _ in PHASES.values()]
    # and only the fold, less one of its steps
    fold_steps = {"fold_v": ("SKIP_FOLD_V", "// fold-v:"),
                  "fold_fetch": ("SKIP_FOLD_FETCH", "// fold-fetch:"),
                  "fold_o": ("SKIP_FOLD_O", "// fold-o:"),
                  "fold_stash": ("SKIP_FOLD_STASH", "// fold-stash:")}
    phases["multi_ttm.cu"].update(fold_steps)
    for name, (macro, _) in fold_steps.items():
        variants[("multi_ttm.cu", f"only_fold_no_{name[5:]}")] = \
            [f"-D{m}" for m, _ in PHASES.values()] + [f"-D{macro}"]

    def compile_one(item):
        (source, name), flags = item
        src = build.BUILD_DIR / f"probe_{source}"
        out = build.BUILD_DIR / f"probe_{source.split('.')[0]}_{name}.so"
        subprocess.run([build.nvcc_path(), *flags, *build.NVCC_FLAGS, "-o", str(out), str(src)],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(out))
        for fn, (restype, argtypes) in build.SIGNATURES[source].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        return (source, name), lib

    for source in ("sweep.cu", "multi_ttm.cu"):
        (build.BUILD_DIR / f"probe_{source}").write_text(
            probe_source((build.CSRC / source).read_text(), phases[source]))
    with ThreadPoolExecutor(len(variants)) as ex:  # one nvcc per variant, all at once
        libs = dict(ex.map(compile_one, variants.items()))

    def pair_run(lib, x, fs, plan):
        pair_mod.library = lambda source: lib
        return cuda_ms(lambda: pair_mod.fused_pair(x, fs, plan=plan), reps=5)

    def ttm_run(lib, x, fs, plan):
        ttm_mod.library = lambda source: lib
        return cuda_ms(lambda: ttm_mod.multi_ttm_keep(x, fs, plan=plan), reps=5)

    cases = [  # (kernel, dims, ranks of the operands, dtypes)
        ("fused_pair", (1000, 1000, 1000), (64, 64), (torch.float32, torch.bfloat16)),
        ("fused_pair", (180, 180, 180, 180), (32, 32, 32), (torch.float32,)),
        ("multi_ttm_keep", (1000, 1000, 1000), (32, 32), (torch.float32, torch.bfloat16)),
        ("multi_ttm_keep", (180, 180, 180, 180), (16, 16, 16), (torch.float32,)),
    ]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for kernel, dims, ranks, dtypes in cases:
        x32 = torch.randn(dims, generator=gen, device="cuda")
        fs32 = [torch.randn((d, r), generator=gen, device="cuda") / d ** 0.5
                for d, r in zip(dims[1:], ranks)]
        for dtype in dtypes:
            x, fs = x32.to(dtype), [f.to(dtype) for f in fs32]
            size = x.element_size()
            if kernel == "fused_pair":
                main_plan = plans.choose_pair_kernel_blocks(dims, ranks[0], size)
                cls, run, source = plans.MTTKRPKernelPlan, pair_run, "sweep.cu"

                def smem(p):
                    return plans.pair_kernel_smem_bytes(p, size, len(dims) - 1)
            else:
                main_plan = plans.choose_multi_ttm_kernel_blocks(dims, ranks, size)
                cls, run, source = plans.MultiTTMKernelPlan, ttm_run, "multi_ttm.cu"

                def smem(p):
                    return plans.multi_ttm_kernel_smem_bytes(p, size, ranks)
            fields = list(main_plan.__dict__.values())
            row_blocks = plans.MULTI_TTM_BLOCK_M if kernel == "multi_ttm_keep" else (64, 128)
            pinned = [cls(rows, width // size, fields[2], stages)
                      for rows in row_blocks for width in (64, 128, 256) for stages in (2, 3, 4)]
            head = {"kernel": kernel, "shape": list(dims), "ranks": list(ranks),
                    "dtype": str(dtype).split(".")[-1]}
            for plan in dict.fromkeys([main_plan] + pinned):
                if smem(plan) > plans.SMEM_PER_CTA_MAX:
                    continue
                print(json.dumps({"probe": "plan", **head, "plan": list(plan.__dict__.values()),
                                  "default": plan == main_plan, "smem_bytes": smem(plan),
                                  "ms": run(libs[(source, "full")], x, fs, plan), "gpu": gpu}),
                      flush=True)
            for src_name, name in variants:
                if src_name != source:
                    continue
                print(json.dumps({"probe": "phase", **head, "plan": fields, "variant": name,
                                  "ms": run(libs[(source, name)], x, fs, main_plan),
                                  "gpu": gpu}), flush=True)
            del x, fs
        del x32, fs32
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
