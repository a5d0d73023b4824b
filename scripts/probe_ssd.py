#!/usr/bin/env python3
"""Time the intra-chunk SSD kernel under each launch plan at the served shape.

    python3 scripts/probe_ssd.py [--seed N]

Needs one CUDA card and nvcc. At Mamba2-2.7b's shape (``chip_smoke.py``'s
``SSD_SHAPE``: BC = 64 chunks of q = 256, N = 128, H = 80, P = 64) it runs
``ssd_intra`` with x in bf16 (the model's mix) and in fp32 under every
plan: 64-row tiles with each divisor of H as the heads per CTA, and 32- and
16-row tiles at the default heads. Each plan is checked against the plain
version (within 1e-2 for bf16 output, 1e-5 for fp32) and timed with CUDA
events; one JSON line per dtype mix, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    from chip_smoke import SSD_SHAPE, cuda_ms, nvidia_smi, rel_err
    from repro_torch.kernels.ssd_intra import SsdPlan, kernel_plan, ssd_intra, ssd_intra_plain

    gpu = nvidia_smi()
    bcn, q, n, h, p = (SSD_SHAPE[k] for k in ("bcn", "q", "n", "h", "p"))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    cc = torch.randn((bcn, q, n), generator=gen, device="cuda")
    bc = torch.randn((bcn, q, n), generator=gen, device="cuda")
    cum = -torch.cumsum(F.softplus(torch.randn((bcn, q, h), generator=gen, device="cuda")), 1)
    dt = F.softplus(torch.randn((bcn, q, h), generator=gen, device="cuda"))
    x32 = torch.randn((bcn, q, h, p), generator=gen, device="cuda")
    default = kernel_plan(q, h, p)
    plans = [SsdPlan(64, d) for d in range(1, h + 1) if h % d == 0 and d >= 4]
    plans += [SsdPlan(32, default.heads), SsdPlan(16, default.heads)]
    for mix, x, tol in (("x_bf16", x32.to(torch.bfloat16), 1e-2), ("f32", x32, 1e-5)):
        want = ssd_intra_plain(cc, bc, cum, dt, x)
        rec = {"probe_ssd": [bcn, q, n, h, p], "mix": mix, "default_plan": list(default),
               "ms": {}, "max_rel_err": 0.0, "gpu": gpu}
        for plan in plans:
            got = ssd_intra(cc, bc, cum, dt, x, plan=plan)
            rel, _ = rel_err(got, want)
            if rel > tol:
                raise AssertionError(f"ssd_intra {mix} {plan}: {rel:.3e} > {tol}")
            rec["max_rel_err"] = max(rec["max_rel_err"], rel)
            rec["ms"][f"tile{plan.tile}_heads{plan.heads}"] = cuda_ms(
                lambda: ssd_intra(cc, bc, cum, dt, x, plan=plan))
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
