#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises, and the script exits non-zero):

1. the card's name and power limit (``nvidia-smi``); no CUDA device -> exit 2;
2. build the Hopper kernels from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (the ``-Xptxas -v`` report is printed);
3. ``mttkrp3`` at 1000x1000x1000, R=64 (extents not multiples of the tiles),
   fp32 and bf16, all three modes through ``kernels.ops``, each against its
   plain version on the card; the 3-way generic variant (``mttkrpn``) too;
4. ``mttkrpn`` at 180^4, R=32, fp32, all four modes;
5. the main path: CP-ALS (``backend="cuda"``) on a 1000^3 tensor of CP rank
   64 plus noise (10 iterations) and on a 180^4 tensor of CP rank 32 plus
   noise (5 iterations), with every kernel's launch count set to 0 before
   and read after; then the same runs with ``backend="einsum"`` from the
   same initial factors, whose fits must agree within 1e-4;
6. one JSON line per kernel and shape (times from CUDA events), the
   ``nvidia-smi`` line, and one ``{"kernels": [...]}`` line;
7. the last line, ``{"ok": true, "device": {...}}``.

All data are made on the card from ``--seed`` with a ``torch.Generator``.
Matmuls run in full fp32 (TF32 off), so the plain versions and the einsum
yardstick are exact fp32.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (dense): fp32 outside the tensor cores, bf16 on
# them, and HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
SOURCE = "src/repro_torch/kernels/csrc/mttkrp.cu"
REPLACES = {
    "mttkrp3": "src/repro/kernels/mttkrp3.py:121",
    "mttkrpn": "src/repro/kernels/mttkrpn.py:208",
    "splitk_reduce": "src/repro/kernels/mttkrp3.py:67",
}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_x: int, itemsize: int, factor_words: int, out_words: int,
          flops: float, dtype: str) -> tuple[float, str]:
    """Least time in ms: each input read once and the fp32 output written
    once at the HBM rate, or the operations at the type's peak rate."""
    t_bytes = (n_x * itemsize + factor_words * itemsize + out_words * 4) / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want| / max |want|, max |got - want|)."""
    diff = float((got.float() - want.float()).abs().max())
    return diff / max(float(want.abs().max()), 1e-30), diff


def check(name: str, got, want, dtype: str) -> tuple[float, float]:
    import torch

    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} or non-finite values")
    rel, diff = rel_err(got, want)
    if rel > TOL[dtype]:
        raise AssertionError(f"{name}: max|d|/max|plain| = {rel:.3e} > {TOL[dtype]}")
    return rel, diff


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def kernel_phases(gen, smi: str, records: dict) -> None:
    """Phases 3 and 4: every kernel against its plain version, timed."""
    import torch
    from repro_torch.core.mttkrp import einsum_spec
    from repro_torch.engine.plan import Memory, choose_blocks
    from repro_torch.kernels import ops, splitk
    from repro_torch.kernels.mttkrp3 import mttkrp3, mttkrp3_plain
    from repro_torch.kernels.mttkrpn import mttkrpn, mttkrpn_plain

    def measure(kname, x, fs, mode, dtype, plain_ref, run_kernel, run_plain):
        xp, fsp = ops.canonicalize(x, fs, mode)
        fsp = [f.contiguous() for f in fsp]
        got = run_kernel(xp, fsp)
        rel, diff = check(f"{kname} mode {mode} {dtype}", got, plain_ref(xp, fsp), dtype)
        ins = [f for k, f in enumerate(fs) if k != mode]
        spec = einsum_spec(x.ndim, mode)
        rank = fs[0].shape[1]
        b_ms, b_by = bound(x.numel(), x.element_size(), sum(f.numel() for f in ins),
                           x.shape[mode] * rank, 2.0 * x.numel() * rank, dtype)
        rec = {
            "kernel": kname, "shape": list(x.shape), "rank": rank, "mode": mode,
            "dtype": dtype, "max_rel_err": rel, "max_abs_err": diff,
            "kernel_ms": cuda_ms(lambda: run_kernel(xp, fsp)),
            "plain_ms": cuda_ms(lambda: run_plain(xp, fsp), reps=3, warm=1),
            "library_ms": cuda_ms(lambda: torch.einsum(spec, x, *ins), reps=3, warm=1),
            "transpose_ms": cuda_ms(lambda: ops.canonicalize(x, fs, mode), reps=3, warm=1)
            if mode else 0.0,
            "bound_ms": b_ms, "bound_by": b_by, "gpu": smi,
        }
        emit(rec)
        records.setdefault(kname, []).append(rec)
        del xp, fsp
        torch.cuda.empty_cache()

    # phase 3: 1000^3, R=64, fp32 then bf16, all modes; the generic variant
    dims, rank = (1000, 1000, 1000), 64
    x = torch.randn(dims, generator=gen, device="cuda")
    fs = [torch.randn((d, rank), generator=gen, device="cuda") / rank ** 0.5 for d in dims]
    plain_cache = {}

    def plain3(mode):
        def fn(xp, fsp):
            if mode not in plain_cache:
                plain_cache[mode] = mttkrp3_plain(xp, *fsp)
            return plain_cache[mode]
        return fn

    for mode in range(3):
        measure("mttkrp3", x, fs, mode, "float32", plain3(mode),
                lambda xp, fsp: mttkrp3(xp, *fsp), lambda xp, fsp: mttkrp3_plain(xp, *fsp))
        measure("mttkrpn", x, fs, mode, "float32", plain3(mode),
                lambda xp, fsp: mttkrpn(xp, fsp), lambda xp, fsp: mttkrpn_plain(xp, fsp))
        got = ops.mttkrp(x, fs, mode)  # the public path: transpose + kernel
        check(f"ops.mttkrp mode {mode}", got, plain_cache[mode], "float32")
    xb = x.to(torch.bfloat16)
    fsb = [f.to(torch.bfloat16) for f in fs]
    for mode in range(3):
        # bf16 inputs against the fp32 plain version of the fp32 data
        measure("mttkrp3", xb, fsb, mode, "bfloat16", plain3(mode),
                lambda xp, fsp: mttkrp3(xp, *fsp), lambda xp, fsp: mttkrp3_plain(xp, *fsp))
        got = ops.mttkrp(xb, fsb, mode, out_dtype=torch.float32)
        check(f"ops.mttkrp bf16 mode {mode}", got, plain_cache[mode], "bfloat16")

    # the split-K reduction at the main shape's workspace
    plan = choose_blocks(dims, rank, memory=Memory.h100_smem())
    gi, gr = -(-dims[0] // plan.block_i), -(-rank // plan.block_r)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    s = max(2, splitk.n_splits(gi * gr, -(-dims[1] // plan.block_contract[0]), sms))
    ws = torch.randn((s, dims[0], rank), generator=gen, device="cuda")
    out = torch.empty((dims[0], rank), device="cuda")
    rel, diff = check("splitk_reduce", splitk.splitk_reduce(ws, out).clone(),
                      splitk.splitk_reduce_plain(ws), "float32")
    n = dims[0] * rank
    b_ms, b_by = bound(n * s, 4, 0, n, (s - 1) * n, "float32")
    rec = {
        "kernel": "splitk_reduce", "shape": [s, dims[0], rank], "dtype": "float32",
        "max_rel_err": rel, "max_abs_err": diff,
        "kernel_ms": cuda_ms(lambda: splitk.splitk_reduce(ws, out)),
        "plain_ms": cuda_ms(lambda: splitk.splitk_reduce_plain(ws)),
        "library_ms": cuda_ms(lambda: torch.sum(ws, 0)),
        "bound_ms": b_ms, "bound_by": b_by, "gpu": smi,
    }
    emit(rec)
    records["splitk_reduce"] = [rec]
    del x, fs, xb, fsb, plain_cache, ws
    torch.cuda.empty_cache()

    # phase 4: 180^4, R=32, fp32, all modes
    dims, rank = (180, 180, 180, 180), 32
    x = torch.randn(dims, generator=gen, device="cuda")
    fs = [torch.randn((d, rank), generator=gen, device="cuda") / rank ** 0.5 for d in dims]
    for mode in range(4):
        measure("mttkrpn", x, fs, mode, "float32", lambda xp, fsp: mttkrpn_plain(xp, fsp),
                lambda xp, fsp: mttkrpn(xp, fsp), lambda xp, fsp: mttkrpn_plain(xp, fsp))
    del x, fs
    torch.cuda.empty_cache()


def noisy_low_rank(gen, dims, rank, noise=0.1):
    """A CP-rank-``rank`` tensor plus Gaussian noise, made on the card."""
    import torch
    from repro_torch.core.tensor import random_factors, tensor_from_factors

    x = tensor_from_factors(random_factors(gen, dims, rank))
    scale = float(x.std())
    x += noise * scale * torch.randn(dims, generator=gen, device="cuda")
    return x


def cp_phase(gen) -> dict:
    """Phase 5: the main path, launches counted, against the einsum backend."""
    import torch
    import repro_torch
    from repro_torch.core.tensor import random_factors
    from repro_torch.kernels import splitk
    from repro_torch.kernels.mttkrp3 import mttkrp3
    from repro_torch.kernels.mttkrpn import mttkrpn

    cases = [((1000, 1000, 1000), 64, 10), ((180, 180, 180, 180), 32, 5)]
    data = []
    for dims, rank, iters in cases:
        x = noisy_low_rank(gen, dims, rank)
        init = random_factors(gen, dims, rank)
        data.append((x, init, rank, iters))
    cuda_ctx = repro_torch.ExecutionContext.create("cuda")
    for k in (mttkrp3, mttkrpn, splitk.splitk_reduce):
        k.launches = 0
    results, times = [], []
    for x, init, rank, iters in data:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = repro_torch.cp_als(x, rank, iters, init_factors=init, ctx=cuda_ctx)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / iters * 1e3)
        results.append(res)
    launches = {
        "mttkrp3": mttkrp3.launches, "mttkrpn": mttkrpn.launches,
        "splitk_reduce": splitk.splitk_reduce.launches,
    }
    want3 = 3 * cases[0][2]
    wantn = 4 * cases[1][2]
    if launches["mttkrp3"] != want3 or launches["mttkrpn"] != wantn:
        raise AssertionError(f"launches {launches}: expected mttkrp3={want3}, mttkrpn={wantn}")
    if launches["splitk_reduce"] not in (0, want3, wantn, want3 + wantn):
        raise AssertionError(f"splitk_reduce launched {launches['splitk_reduce']} times")
    if launches["splitk_reduce"] == 0:
        raise AssertionError("the split-K reduction never ran on the main path")
    ein_ctx = repro_torch.ExecutionContext.create("einsum")
    out = {"launches": launches, "cp": []}
    for (x, init, rank, iters), res, ms in zip(data, results, times):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = repro_torch.cp_als(x, rank, iters, init_factors=init, ctx=ein_ctx)
        torch.cuda.synchronize()
        ein_ms = (time.perf_counter() - t0) / iters * 1e3
        gap = max(abs(a - b) for a, b in zip(res.fits, ref.fits))
        finite = all(bool(torch.isfinite(f).all()) for f in res.factors)
        rose = 0.0 < res.fits[0] < res.final_fit <= 1.0
        if not finite or len(res.fits) != iters or gap > 1e-4 or not rose:
            raise AssertionError(
                f"cp_als {tuple(x.shape)}: fits {res.fits} vs einsum {ref.fits} "
                f"(gap {gap:.2e}), finite={finite}"
            )
        rec = {
            "cp_als": list(x.shape), "rank": rank, "iters": iters, "fits": res.fits,
            "einsum_fits": ref.fits, "max_fit_gap": gap, "iter_ms_cuda": ms,
            "iter_ms_einsum": ein_ms,
        }
        emit(rec)
        out["cp"].append(rec)
    del data, results
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)  # phase 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()  # phase 2
    path, log = build.build()
    build.library()
    print(f"built {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        print(f"nvcc: {line}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    records: dict = {}
    kernel_phases(gen, smi, records)  # phases 3 and 4
    main_path = cp_phase(gen)  # phase 5

    main_shape = {"mttkrp3": [1000, 1000, 1000], "mttkrpn": [180, 180, 180, 180]}
    kernels = []
    for name in ("mttkrp3", "mttkrpn", "splitk_reduce"):
        rows = [r for r in records[name] if r["dtype"] == "float32"]
        head = next(
            (r for r in rows if r["shape"] == main_shape.get(name) and r.get("mode", 0) == 0),
            rows[0],
        )
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": main_path["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
        })
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
