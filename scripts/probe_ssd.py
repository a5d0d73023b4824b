#!/usr/bin/env python3
"""Where the intra-chunk SSD kernel spends its time, and its time by plan.

    python3 scripts/probe_ssd.py [--seed N]

Needs one CUDA card and nvcc. At Mamba2-2.7b's shape (``chip_smoke.py``'s
``SSD_SHAPE``: BC = 64 chunks of q = 256, N = 128, H = 80, P = 64) it runs
``ssd_intra`` with x in bf16 (the model's mix) and in fp32. Two
measurements, printed as JSON lines with the card's name and power limit:

* ``plan``: the kernel under every plan that fits one CTA: 64-, 32- and
  16-row tiles, each with every divisor of H from 4 up as the heads per
  CTA, beside the default plan (``kernel_plan``). Each plan is checked
  against the plain version (within 1e-2 for bf16 output, 1e-5 for fp32).
* ``phase``: the default plan's launch with one phase compiled out, as
  ``scripts/probe_ring.py`` does for the ring kernels: the ring copies of
  the next step's X tiles, cum and dt (``ring_copies``), the tensor-core
  products of W X (``mma``), the build of the weights with their exps
  (``w_build``), or the Gram (``gram``); and with all four out
  (``none``: the barriers, the launch and the output stores). The
  variants compute wrong results on purpose: the difference to the full
  kernel is the time that phase costs when the others still run.

Times are CUDA-event means over 10 launches after 2 warm-ups. The variant
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
#: Without its products, the weights a warp built would be dead code: each
#: mix's stand-in (bf16 first, as in the source) folds them into one sum.
KEEP_W = (
    "part[0][0] += __uint_as_float((ahi[0] ^ ahi[1] ^ ahi[2] ^ ahi[3] ^ alo[0] ^ alo[1] ^\n"
    "                               alo[2] ^ alo[3]) & 0x3f800000u);",
    "part[0][0] += __uint_as_float((ah[0] ^ ah[1] ^ ah[2] ^ ah[3] ^ al[0] ^ al[1] ^ al[2] ^\n"
    "                               al[3]) & 0x3f800000u);",
)
PHASES = {  # variant -> (macro, comment line that opens the phase's blocks[, stand-ins])
    "ring_copies": ("SKIP_COPY", "// ring copies:"),
    "mma": ("SKIP_MMA", "// MMA:", KEEP_W),
    "w_build": ("SKIP_W", "// W build:"),
    "gram": ("SKIP_GRAM", "// Gram:"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("probe_ssd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from chip_smoke import SSD_SHAPE, cuda_ms, nvidia_smi, rel_err
    from probe_mttkrp import probe_source
    from repro_torch.engine.plan import SMEM_PER_CTA_MAX
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_intra as ssd_mod

    gpu = nvidia_smi()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    variants = {"full": []}
    variants.update({f"no_{name}": [f"-D{phase[0]}"] for name, phase in PHASES.items()})
    variants["none"] = [f"-D{phase[0]}" for phase in PHASES.values()]
    src = build.BUILD_DIR / "probe_ssd_intra.cu"
    src.write_text(probe_source((build.CSRC / "ssd_intra.cu").read_text(), PHASES))

    def compile_one(item):
        name, flags = item
        out = build.BUILD_DIR / f"probe_ssd_intra_{name}.so"
        subprocess.run([build.nvcc_path(), *flags, *build.NVCC_FLAGS, "-o", str(out), str(src)],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(out))
        for fn, (restype, argtypes) in build.SIGNATURES["ssd_intra.cu"].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        return name, lib

    with ThreadPoolExecutor(len(variants)) as ex:  # one nvcc per variant, all at once
        libs = dict(ex.map(compile_one, variants.items()))

    def run(name, operands, plan):
        ssd_mod.library = lambda source: libs[name]
        return cuda_ms(lambda: ssd_mod.ssd_intra(*operands, plan=plan))

    bcn, q, n, h, p = (SSD_SHAPE[k] for k in ("bcn", "q", "n", "h", "p"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    cc = torch.randn((bcn, q, n), generator=gen, device="cuda")
    bc = torch.randn((bcn, q, n), generator=gen, device="cuda")
    cum = -torch.cumsum(F.softplus(torch.randn((bcn, q, h), generator=gen, device="cuda")), 1)
    dt = F.softplus(torch.randn((bcn, q, h), generator=gen, device="cuda"))
    x32 = torch.randn((bcn, q, h, p), generator=gen, device="cuda")
    for mix, x, tol in (("x_bf16", x32.to(torch.bfloat16), 1e-2), ("f32", x32, 1e-5)):
        operands = (cc, bc, cum, dt, x)
        itemsize = x.element_size()
        default = ssd_mod.kernel_plan(q, h, p, itemsize, bcn=bcn, sms=sms)
        head = {"probe_ssd": [bcn, q, n, h, p], "mix": mix, "gpu": gpu}
        want = ssd_mod.ssd_intra_plain(*operands)
        plans = [ssd_mod.SsdPlan(tile, d) for tile in (64, 32, 16)
                 for d in range(4, h + 1) if h % d == 0]
        for plan in dict.fromkeys([default] + plans):
            smem = ssd_mod.kernel_smem_bytes(q, p, plan.tile, itemsize)
            if smem > SMEM_PER_CTA_MAX:
                continue
            ssd_mod.library = lambda source: libs["full"]
            rel, _ = rel_err(ssd_mod.ssd_intra(*operands, plan=plan), want)
            if rel > tol:
                raise AssertionError(f"ssd_intra {mix} {plan}: {rel:.3e} > {tol}")
            print(json.dumps({"probe": "plan", **head, "plan": list(plan),
                              "default": plan == default, "smem_bytes": smem,
                              "max_rel_err": rel, "ms": run("full", operands, plan)}),
                  flush=True)
        for name in variants:
            print(json.dumps({"probe": "phase", **head, "plan": list(default), "variant": name,
                              "ms": run(name, operands, default)}), flush=True)
        del want
    return 0


if __name__ == "__main__":
    sys.exit(main())
