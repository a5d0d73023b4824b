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
(``observe=True``), and on ``backend="auto"`` on a tune-cache hit for the
chooser's plan, through the default cache and through a context's
``cache_path`` (phase 12's probe of ``chip_smoke.py``; both caches are
throwaway files), the states alternated call by call. One JSON line,
with the card's name and power limit and each state's median over
``no_trace``'s.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
    if importlib.util.find_spec("repro_torch.tune") is not None:
        from repro_torch.engine.plan import choose_mttkrp_kernel_blocks
        from repro_torch.tune import cache as tcache
        from repro_torch.tune import search

        tmp = tempfile.mkdtemp(prefix="probe-host-")
        os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join(tmp, "default.json")
        key = tcache.cache_key((64, 64, 64), 16, 0, torch.float32,
                               repro_torch.Memory.h100_smem())
        on_path = repro_torch.ExecutionContext.create("auto",
                                                      cache_path=os.path.join(tmp, "path.json"))
        for cache in (tcache.default_cache(), on_path.plan_cache()):
            cache.put(key, tcache.CacheEntry("cuda", tcache.plan_to_dict(
                choose_mttkrp_kernel_blocks((64, 64, 64), 16, 4))), persist=False)
            if not search.resolve((64, 64, 64), 16, 0, torch.float32, device="cuda",
                                  cache=cache).cache_hit:
                raise AssertionError("probe_host: the auto state misses its cache")
        states["auto"] = (repro_torch.ExecutionContext.create("auto"), None)
        states["auto_cache_path"] = (on_path, None)
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
    if "auto" in states:
        shutil.rmtree(tmp, ignore_errors=True)
    for v in out.values():
        v["over_no_trace"] = v["median_us"] / out["no_trace"]["median_us"]
    print(json.dumps({"probe_host": args.label or os.path.abspath(args.src),
                      "shape": [64, 64, 64], "rank": 16, "calls": args.calls, "states": out,
                      "gpu": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
