"""Tucker decomposition via Multi-TTM, on the PyTorch/CUDA port.

The steps of ``examples/tucker.py``: an exact multilinear-rank tensor
decomposed by HOOI through three backends (``einsum``, the blocked host
schedule, the Hopper Multi-TTM kernel ``cuda``), the sequential Multi-TTM
accounting, the distributed grid selection over the Multi-TTM sweep
objective, and a pinned context round-tripping through JSON.

    PYTHONPATH=src python examples/torch_tucker.py [--device cpu]

Set ``REPRO_EX_TINY=1`` for the CI-sized problem.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

import repro_torch
from repro_torch.core import bounds
from repro_torch.core.tensor import random_tucker_tensor
from repro_torch.distributed.grid_select import multi_ttm_sweep_words, select_tucker_grid

TINY = os.environ.get("REPRO_EX_TINY") == "1"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = ap.parse_args().device
    dims = (12, 10, 8) if TINY else (40, 36, 32)
    ranks = (4, 3, 2) if TINY else (8, 6, 4)
    n_iters = 3 if TINY else 8
    print(f"tensor {dims}, Tucker ranks {ranks}, device {device}")
    x, _, _ = random_tucker_tensor(torch.Generator(device=device).manual_seed(0), dims, ranks)

    # one context a backend; the same ctx drives every Multi-TTM of the run
    # (HOSVD, each HOOI mode update, and the core)
    for backend in ("einsum", "blocked_host", "cuda"):
        ctx = repro_torch.ExecutionContext.create(backend, device=device)
        res = repro_torch.tucker_hooi(x, ranks, n_iters=n_iters, ctx=ctx)
        print(f"  backend={backend:18s} fit={res.final_fit:.5f}")

    # the Multi-TTM sequential accounting (arXiv:2207.10437)
    mem = 1024 if TINY else 4096
    canon, cranks = dims, ranks[1:]  # keep mode 0 first
    b = bounds.multi_ttm_best_block_size(canon, cranks, mem)
    print(f"\nsequential Multi-TTM model (fast memory M = {mem} words):")
    print(f"  lower bound (HBL + trivial I/O): "
          f"{bounds.multi_ttm_seq_lb(canon, cranks, mem):,.0f} words")
    print(f"  blocked schedule (b={b}):         "
          f"{bounds.multi_ttm_blocked_cost(canon, cranks, b):,.0f} words")
    print(f"  unblocked:                       "
          f"{bounds.multi_ttm_unblocked_cost(canon, cranks):,.0f} words")
    # distributed grid selection over the Multi-TTM sweep objective (the
    # distributed Tucker sweep itself comes with the next slice)
    for procs in (4, 8):
        choice = select_tucker_grid(dims, ranks, procs)
        print(f"  P={procs}: sweep-optimal grid {choice.grid} "
              f"({choice.words:,.0f} words/processor/sweep; model "
              f"{multi_ttm_sweep_words(dims, ranks, choice.grid):,.0f})")

    # a pinned Tucker context: the kind="multi_ttm" decisions resolved once
    ctx = repro_torch.ExecutionContext.for_problem(dims, ranks, backend="auto", device=device)
    print("\npinned multi_ttm decisions:", [(d.mode, d.backend, d.cache_hit)
                                            for d in ctx.decisions])
    ctx2 = repro_torch.ExecutionContext.from_json(ctx.to_json())
    assert ctx2 == ctx and ctx2.decisions == ctx.decisions
    res = repro_torch.tucker_hooi(x, ranks, n_iters=2, ctx=ctx2)
    print(f"  tucker_hooi(ctx from JSON) fit={res.final_fit:.5f} "
          f"({len(ctx.to_json())} bytes round-tripped)")


if __name__ == "__main__":
    main()
