#!/usr/bin/env python3
"""Where a CP-ALS iteration and a Tucker/HOOI sweep spend their device time.

    python3 scripts/profile_sweeps.py [--seed N] [--serve | --train]

Needs one CUDA card and nvcc. For the two CP-ALS problems of
``chip_smoke.py`` (a 1000^3 tensor of CP rank 64 plus noise, R=64, and a
180^4 tensor of CP rank 32 plus noise, R=32) and each schedule
(``per_mode``, ``fused``, ``dimtree``, all on ``backend="cuda"``) it runs
one untimed CP-ALS iteration, then two iterations under ``torch.profiler``
(CPU and CUDA activities); for its two Tucker problems (1000^3 of
multilinear rank (32, 32, 32) and 180^4 of rank (16, 16, 16, 16), each
plus 10 % noise) one untimed HOOI sweep from HOSVD factors, then two
profiled sweeps; for ``chip_smoke.py``'s Mamba2 serving cell
(``mamba2-2.7b`` at full width and depth in bf16, 4 prompts x 4096 tokens)
one untimed prefill, then two profiled. With ``--serve`` it profiles
only the server's buckets (``chip_smoke.py`` phase 11: 16 x 256^3 at R=32,
64 x 96^3 and 8 x 64^4 at R=16): one ``cp_als_batched`` iteration untimed,
then two profiled (``backend="auto"``, as the server runs them). With
``--train`` it profiles only ``chip_smoke.py``'s training cell (phase 9g:
``mamba2-2.7b`` at full width and depth in bf16, one train step on 2 x
2048 tokens, remat ``full``): one step untimed, then one profiled. Each
prints one JSON line:

* ``wall_ms``: host time per iteration, between two synchronizations;
* ``busy_ms``: the device time per iteration of every kernel and copy the
  profiler recorded (one stream, so they do not overlap), and
  ``idle_share = 1 - busy_ms / wall_ms``;
* ``groups_ms``: that device time per iteration by group: the port's kernels
  by name, ``copy`` (the transposes and casts), and ``other`` (the solves,
  Gram matrices and the fit); for HOOI also ``gram_eigh``, the kernels
  launched under the Gram and ``eigh`` of each mode update (attributed
  through the profiler's CPU op tree, and taken out of ``copy``); for the
  prefill ``ssd_intra``, ``gemm`` (cuBLAS: the projections, the chunk
  states, the inter-chunk output and the logits), ``copy`` and ``other``;
  for the train step also ``ssd_backward`` (the kernels of ``SsdIntra``'s
  backward, attributed through the profiler's CPU op tree) and ``adamw``
  (those of ``adamw_update``), each taken out of the name groups;
* ``top``: the ten most expensive device functions by name.

The profiler adds host overhead, so ``wall_ms`` reads a little above
``chip_smoke.py``'s ``iter_ms_cuda``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = (  # (group, pattern in the device function's name), first match wins
    ("fused_pair", r"fused_pair_mma_kernel"),
    ("multi_ttm_keep", r"multi_ttm_mma_kernel"),
    ("mttkrp_partial", r"partial_kernel"),
    ("mttkrp3", r"mttkrp_mma_kernel<[^,]+, 2,"),  # the 3-way specialization
    ("mttkrpn", r"mttkrp_mma_kernel<[^,]+, 0,"),  # the generic kernel
    ("splitk_reduce", r"splitk_reduce_kernel"),
    ("copy", r"copy"),
)


PREFILL_GROUPS = (  # the Mamba2 prefill's groups
    ("ssd_intra", r"ssd_intra_kernel"),
    ("gemm", r"gemm|xmma|nvjet|cutlass|cublas"),
    ("copy", r"copy"),
)


TRAIN_GROUPS = PREFILL_GROUPS  # the train step's by name, before the attributed ones
SSD_BACKWARD = "autograd::engine::evaluate_function: SsdIntraBackward"


def group_of(name: str, groups=GROUPS) -> str:
    for group, pattern in groups:
        if re.search(pattern, name):
            return group
    return "other"


def profiled(fn, iters: int, groups=GROUPS):
    """Run ``fn`` under the profiler; returns (wall ms, busy ms, groups ms,
    top) per iteration, and the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    by_group: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for evt in prof.events():
        # a record_function range shows on the device timeline too: not work
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.is_user_annotation:
            continue
        ms = evt.time_range.elapsed_us() / 1e3 / iters
        group = group_of(evt.name, groups)
        by_group[group] = by_group.get(group, 0.0) + ms
        by_name[evt.name] = by_name.get(evt.name, 0.0) + ms
    busy = sum(by_group.values())
    if busy == 0.0:
        raise RuntimeError("the profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return wall, busy, by_group, [[name[:120], ms] for name, ms in top], prof


def under(prof, label: str, iters: int, groups=GROUPS) -> dict[str, float]:
    """Device ms per iteration, by group, of the kernels launched by CPU ops
    inside a ``record_function(label)`` range (or the CPU event of that
    name, such as an autograd node's evaluation)."""
    import torch

    out: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU or not evt.kernels:
            continue
        p = evt
        while p is not None and p.name != label:
            p = p.cpu_parent
        if p is not None:
            for k in evt.kernels:
                g = group_of(k.name, groups)
                out[g] = out.get(g, 0.0) + k.duration / 1e3 / iters
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--serve", action="store_true", help="only the server's buckets")
    ap.add_argument("--train", action="store_true", help="only the Mamba2 train step")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_sweeps: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from torch.profiler import record_function

    import repro_torch
    import repro_torch.core.tucker as tucker_mod
    from chip_smoke import PREFILL, noisy_low_rank, noisy_tucker, nvidia_smi
    from repro_torch.core.tensor import random_factors
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = nvidia_smi()
    for source in ("ssd_intra.cu",) if args.train else build.build_all():
        build.library(source)
    ctx = repro_torch.ExecutionContext.create("cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    iters = 2
    if args.train:
        return profile_train(gen, gpu)
    if args.serve:
        return profile_buckets(gen, gpu, iters)
    for dims, rank in [((1000, 1000, 1000), 64), ((180, 180, 180, 180), 32)]:
        x = noisy_low_rank(gen, dims, rank)
        init = random_factors(gen, dims, rank)
        for sweep in ("per_mode", "fused", "dimtree"):
            repro_torch.cp_als(x, rank, 1, init_factors=init, sweep=sweep, ctx=ctx)
            torch.cuda.synchronize()
            wall, busy, groups, top, _ = profiled(lambda: repro_torch.cp_als(
                x, rank, iters, init_factors=init, sweep=sweep, ctx=ctx), iters)
            print(json.dumps({
                "profile": list(dims), "rank": rank, "sweep": sweep, "wall_ms": wall,
                "busy_ms": busy, "idle_share": 1.0 - busy / wall, "groups_ms": groups,
                "top": top, "gpu": gpu,
            }), flush=True)
        del x, init
        torch.cuda.empty_cache()

    # Tucker/HOOI: the Gram and eigh of each mode update run inside a
    # record_function range, so their kernels can be told from the rest
    gram_eigvecs = tucker_mod._gram_eigvecs

    def annotated(m, r):
        with record_function("gram_eigh"):
            return gram_eigvecs(m, r)

    tucker_mod._gram_eigvecs = annotated
    for dims, ranks in [((1000, 1000, 1000), (32, 32, 32)), ((180, 180, 180, 180), (16,) * 4)]:
        x = noisy_tucker(gen, dims, ranks)
        init = tucker_mod.hosvd_init(x, ranks)
        repro_torch.tucker_hooi(x, ranks, 1, init_factors=init, ctx=ctx)
        torch.cuda.synchronize()
        wall, busy, groups, top, prof = profiled(lambda: repro_torch.tucker_hooi(
            x, ranks, iters, init_factors=init, ctx=ctx), iters)
        inside = under(prof, "gram_eigh", iters)
        if not inside:
            raise RuntimeError("no kernel was attributed to the Gram and eigh")
        groups["copy"] = groups.get("copy", 0.0) - inside.get("copy", 0.0)
        groups["other"] = groups.get("other", 0.0) - sum(
            v for g, v in inside.items() if g != "copy")
        groups["gram_eigh"] = sum(inside.values())
        print(json.dumps({
            "profile_tucker": list(dims), "ranks": list(ranks), "wall_ms": wall,
            "busy_ms": busy, "idle_share": 1.0 - busy / wall, "groups_ms": groups,
            "gram_eigh_by_group_ms": inside, "top": top, "gpu": gpu,
        }), flush=True)
        del x, init
        torch.cuda.empty_cache()
    tucker_mod._gram_eigvecs = gram_eigvecs

    # the Mamba2 prefill that chip_smoke.py phase 9 serves
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params

    cfg = get_config("mamba2-2.7b")
    model = init_params(cfg, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, PREFILL, generator=gen, device="cuda")

    def prefill():
        for _ in range(iters):
            forward(model, cfg, {"tokens": tokens}, mode="prefill", logits_positions="last")

    forward(model, cfg, {"tokens": tokens}, mode="prefill", logits_positions="last")
    torch.cuda.synchronize()
    wall, busy, groups, top, _ = profiled(prefill, iters, PREFILL_GROUPS)
    print(json.dumps({
        "profile_prefill": cfg.name, "dtype": cfg.dtype, "prompts": PREFILL[0],
        "prompt_tokens": PREFILL[1], "wall_ms": wall, "busy_ms": busy,
        "idle_share": 1.0 - busy / wall, "groups_ms": groups, "top": top, "gpu": gpu,
    }), flush=True)
    return 0


def profile_train(gen, gpu: str) -> int:
    """``chip_smoke.py``'s training cell (phase 9g): one train step of
    ``mamba2-2.7b`` in bf16 at full width and depth on a fixed
    ``synthetic_batch`` of ``TRAIN_BATCH``, after one untimed."""
    import torch
    from torch.profiler import record_function

    from chip_smoke import TRAIN_BATCH
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.training import build_train_step, init_train_state
    from repro_torch.training import steps as steps_mod

    cfg = get_config("mamba2-2.7b")
    batch, seq = TRAIN_BATCH
    state = init_train_state(cfg, generator=gen)
    data = synthetic_batch(DataConfig(cfg.vocab_size, seq, batch), 0)
    real = steps_mod.adamw_update

    def adamw_update(*args, **kwargs):
        with record_function("adamw_update"):
            return real(*args, **kwargs)

    steps_mod.adamw_update = adamw_update
    step = build_train_step(cfg)
    box = list(step(state, data))  # untimed
    del state
    torch.cuda.synchronize()

    def one():
        box[0], box[1] = step(box[0], data)

    wall, busy, groups, top, prof = profiled(one, 1, TRAIN_GROUPS)
    for name, label in (("ssd_backward", SSD_BACKWARD), ("adamw", "adamw_update")):
        inside = under(prof, label, 1, TRAIN_GROUPS)
        for g, ms in inside.items():
            groups[g] -= ms
        groups[name] = sum(inside.values())
    print(json.dumps({
        "profile_train": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
        "remat": cfg.remat, "batch": [batch, seq], "wall_ms": wall, "busy_ms": busy,
        "idle_share": 1.0 - busy / wall, "groups_ms": groups, "top": top,
        "loss": float(box[1]["loss"]), "gpu": gpu,
    }), flush=True)
    return 0


def profile_buckets(gen, gpu: str, iters: int) -> int:
    """The server's buckets (``chip_smoke.SERVE_QUEUE``, ``SERVE_4WAY``) as
    one ``cp_als_batched`` run each on ``backend="auto"``, the elements at
    the bucket shape."""
    import torch

    import repro_torch
    from chip_smoke import SERVE_4WAY, SERVE_QUEUE, noisy_low_rank
    from repro_torch.core.tensor import random_factors
    from repro_torch.tune.cache import isolated_cache

    auto = repro_torch.ExecutionContext.create("auto")
    with isolated_cache():
        for count, (_, hi), rank, ways in SERVE_QUEUE + SERVE_4WAY:
            dims = (hi,) * ways
            xs = torch.stack([noisy_low_rank(gen, dims, rank) for _ in range(count)])
            init = [torch.stack(f) for f in zip(*(random_factors(gen, dims, rank)
                                                  for _ in range(count)))]
            repro_torch.cp_als_batched(xs, rank, 1, init_factors=init, ctx=auto)
            torch.cuda.synchronize()
            wall, busy, groups, top, _ = profiled(lambda: repro_torch.cp_als_batched(
                xs, rank, iters, init_factors=init, ctx=auto), iters)
            print(json.dumps({
                "profile_bucket": [count, *dims], "rank": rank, "wall_ms": wall,
                "busy_ms": busy, "idle_share": 1.0 - busy / wall, "groups_ms": groups,
                "top": top, "gpu": gpu,
            }), flush=True)
            del xs, init
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
