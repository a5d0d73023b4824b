"""Quickstart, on the PyTorch/CUDA port: CP decomposition with
communication-optimal MTTKRP.

The steps of ``examples/quickstart.py``: one ``repro_torch.ExecutionContext``
a backend drives every MTTKRP of a CP-ALS run on a synthetic low-rank
tensor, through ``einsum``, the blocked host schedule (Algorithm 2) and the
hand-written Hopper kernels (``cuda``); the explicit Khatri-Rao matmul
baseline through ``mttkrp_fn``; the paper's sequential communication
accounting; then the tuner, and the tuned setup round-tripping through
JSON. All three backends print the same fit.

    PYTHONPATH=src python examples/torch_quickstart.py                # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # on the host
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

import repro_torch
from repro_torch.core import bounds
from repro_torch.core.krp import mttkrp_via_matmul
from repro_torch.core.tensor import random_factors, random_low_rank_tensor


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = ap.parse_args().device
    dims, rank = (48, 40, 32), 6
    print(f"tensor {dims}, CP rank {rank}, device {device}")
    x, _ = random_low_rank_tensor(torch.Generator(device=device).manual_seed(0), dims, rank)
    init = random_factors(torch.Generator(device=device).manual_seed(1), dims, rank)

    # one context per backend; the same ctx drives every MTTKRP of the run
    for backend in ("einsum", "blocked_host", "cuda"):
        ctx = repro_torch.ExecutionContext.create(backend, device=device)
        res = repro_torch.cp_als(x, rank, n_iters=12, init_factors=init, ctx=ctx)
        print(f"  backend={backend:22s} fit={res.final_fit:.5f}")
    # a custom mttkrp_fn still overrides the engine (the paper's §VI-A
    # matmul baseline is not an engine backend)
    ctx = repro_torch.ExecutionContext.create("einsum", device=device)
    res = repro_torch.cp_als(x, rank, n_iters=12, init_factors=init, ctx=ctx,
                             mttkrp_fn=mttkrp_via_matmul)
    print(f"  backend={'krp_matmul_baseline':22s} fit={res.final_fit:.5f}")

    # the paper's sequential communication accounting: a fast memory far
    # smaller than the tensor, so blocking matters (M = 4096 words)
    mem = 4096
    b = bounds.best_block_size(dims, mem)
    print("\nsequential model (fast memory M = %d words):" % mem)
    print(f"  lower bound (Thm 4.1 / Fact 4.1): {bounds.seq_lb(dims, rank, mem):,.0f} words")
    print(f"  Algorithm 2 (blocked, b={b}):      "
          f"{bounds.seq_blocked_cost(dims, rank, b):,.0f} words")
    print(f"  Algorithm 1 (unblocked):          "
          f"{bounds.seq_unblocked_cost(dims, rank):,.0f} words")
    print(f"  matmul baseline (§VI-A):          "
          f"{bounds.matmul_seq_cost(dims, rank, mem):,.0f} words")

    # --- the tuner: backend="auto" ----------------------------------------
    # candidate plans measured on this device, the winner persisted in a
    # plan cache and replayed by every later call (a throwaway cache here)
    from repro_torch.tune.cache import isolated_cache
    from repro_torch.tune.search import tune_mttkrp

    with isolated_cache():
        factors = random_factors(torch.Generator(device=device).manual_seed(2), dims, rank)
        res = tune_mttkrp(x, factors, 0, ctx=repro_torch.ExecutionContext.create(
            "auto", device=device))
        print(f"\nautotuner winner: {res.winner.label} "
              f"(metric={res.metric}, {len(res.measurements)} candidates)")
        # for_problem pins every "auto" decision (one a mode) once; drivers
        # replay them
        ctx = repro_torch.ExecutionContext.for_problem(dims, rank, backend="auto",
                                                       device=device)
        print("  pinned decisions:", [(d.mode, d.backend, d.cache_hit) for d in ctx.decisions])
        b0 = repro_torch.mttkrp(x, factors, 0, ctx=ctx)
        print(f"  mttkrp(ctx) -> {tuple(b0.shape)}")
        ctx2 = repro_torch.ExecutionContext.from_json(ctx.to_json())
        assert ctx2 == ctx and ctx2.decisions == ctx.decisions
        print(f"  to_json/from_json round-trip OK ({len(ctx.to_json())} bytes); set "
              f"REPRO_TORCH_CONTEXT to replay it")


if __name__ == "__main__":
    main()
