#!/usr/bin/env python3
"""The host's µs for one engine call, for comparing two checkouts.

    python3 scripts/probe_host.py [--src DIR] [--label NAME] [--calls N]

Needs one CUDA card and nvcc. Imports ``repro_torch`` from ``DIR`` (default
this checkout's ``src``), so an unpacked earlier commit can be timed by the
same script: run it on both trees in turns (A, B, B, A) in one job on one
card. Each run times ``repro_torch.mttkrp`` at 64^3, R = 16 on
``backend="cuda"`` (mode 0: the kernel and its split-K reduction, no
transpose), call by call with the host's clock (no synchronization inside
a call; one every 20 calls), after 50 untimed calls, and prints the
median, the quartiles and the minimum of ``--calls`` calls. With no trace
active this is the path every untraced caller pays. Where the tree has
``repro_torch.observe``, it also times the call under a trace whose gate
refuses it (``capture="observed"``, ``observe=False``) and traced
(``observe=True``), the states alternated call by call. One JSON line,
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default=None)
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_host: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    import repro_torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((64, 64, 64), generator=gen, device="cuda")
    fs = [torch.randn((64, 16), generator=gen, device="cuda") for _ in range(3)]
    plain = repro_torch.ExecutionContext.create("cuda")
    states = {"no_trace": (plain, None)}
    if hasattr(repro_torch, "Trace"):
        obs = repro_torch.ExecutionContext.create("cuda", observe=True)
        states["gate_refuses"] = (plain, repro_torch.Trace(capture="observed"))
        states["traced"] = (obs, repro_torch.Trace(capture="observed",
                                                   capacity=args.calls + 100))
    samples: dict = {name: [] for name in states}
    for i in range(args.calls + 50):
        for name in (list(states) if i % 2 == 0 else list(states)[::-1]):
            ctx, trace = states[name]
            if trace is not None:
                trace.__enter__()
            t0 = time.perf_counter()
            repro_torch.mttkrp(x, fs, 0, ctx=ctx)
            dt = time.perf_counter() - t0
            if trace is not None:
                trace.__exit__(None, None, None)
            if i >= 50:
                samples[name].append(dt * 1e6)
        if i % 20 == 19:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    out = {}
    for name, v in samples.items():
        v = sorted(v)
        out[name] = {"median_us": v[len(v) // 2], "q1_us": v[len(v) // 4],
                     "q3_us": v[3 * len(v) // 4], "min_us": v[0]}
    print(json.dumps({"probe_host": args.label or os.path.abspath(args.src),
                      "shape": [64, 64, 64], "rank": 16, "calls": args.calls, "states": out,
                      "gpu": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
