"""Tucker decomposition via Multi-TTM, on the PyTorch/CUDA port.

The steps of ``examples/tucker.py``: an exact multilinear-rank tensor
decomposed by HOOI through three backends (``einsum``, the blocked host
schedule, the Hopper Multi-TTM kernel ``cuda``), the sequential Multi-TTM
accounting, the distributed grid selection over the Multi-TTM sweep
objective, the distributed HOOI on ``--procs`` ranks this script starts
(gloo; NCCL where each rank has a card of its own: rank 0 prints the
chosen grid and each sweep's counted collective bytes next to
``multi_ttm_sweep_words``), and a pinned context round-tripping through
JSON. Everything runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_tucker.py [--procs 4] [--device cpu]

Set ``REPRO_EX_TINY=1`` for the CI-sized problem.
"""

import argparse
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch
import torch.distributed as dist

import repro_torch
from repro_torch.core import bounds
from repro_torch.core.tensor import random_tucker_tensor
from repro_torch.distributed.grid_select import multi_ttm_sweep_words, select_tucker_grid
from repro_torch.observe.metrics import SWEEP_COLLECTIVE_BYTES, registry

TINY = os.environ.get("REPRO_EX_TINY") == "1"
DIMS = (12, 10, 8) if TINY else (40, 36, 32)
RANKS = (4, 3, 2) if TINY else (8, 6, 4)
N_ITERS = 3 if TINY else 8


def problem(device):
    """The example's tensor, the same on every rank (one seed)."""
    x, _, _ = random_tucker_tensor(torch.Generator(device=device).manual_seed(0), DIMS, RANKS)
    return x


def rank_main(rank: int, world: int, store: str, device: str) -> None:
    """One rank of the distributed HOOI: every rank calls
    ``repro_torch.tucker_hooi`` with the whole tensor on a distributed
    context; X stays in its block, each sweep moves one hyperslice
    all-reduce and one fiber all-gather of the partial Y^(k) a mode."""
    backend = "nccl" if device == "cuda" and torch.cuda.device_count() >= world else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        x = problem(device)
        ctx = repro_torch.ExecutionContext.create("cuda", device=device, distributed=True,
                                                  observe=True)
        hist0 = len(registry().histogram(SWEEP_COLLECTIVE_BYTES))
        with repro_torch.Trace() as tr:
            res = repro_torch.tucker_hooi(x, RANKS, n_iters=N_ITERS, ctx=ctx)
        (event,) = [e for e in tr.events if e["kind"] == "tucker_sweep_collectives"]
        if rank == 0:
            grid = tuple(event["grid"])
            model = multi_ttm_sweep_words(DIMS, RANKS, grid) * 4
            print(f"\ndistributed HOOI on {world} ranks ({backend}): grid "
                  f"{'x'.join(map(str, grid))}")
            for i, got in enumerate(registry().histogram(SWEEP_COLLECTIVE_BYTES)[hist0:]):
                print(f"  sweep {i}: counted {got:,.0f} bytes, multi_ttm_sweep_words x 4 "
                      f"{model:,.0f}")
            print(f"  fit={res.final_fit:.5f} (every rank holds the same factors and core)",
                  flush=True)
    finally:
        dist.destroy_process_group()


def run_ranks(procs: int, device: str) -> None:
    """Start ``procs`` rank processes of this script on one file store and
    wait for them."""
    sys.stdout.flush()
    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "GLOO_SOCKET_IFNAME": os.environ.get("GLOO_SOCKET_IFNAME", "lo")}
        ranks = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--procs",
                                   str(procs), "--device", device, "--rank", str(r),
                                   "--store", os.path.join(tmp, "store")], env=env)
                 for r in range(procs)]
        try:
            codes = [p.wait(timeout=600) for p in ranks]
        finally:
            for p in ranks:
                if p.poll() is None:
                    p.kill()
        if any(codes):
            raise SystemExit(f"a rank failed: exit codes {codes}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--procs", type=int, default=4, choices=(2, 4, 8))
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args.rank, args.procs, args.store, args.device)
    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the host")
    dims, ranks, n_iters = DIMS, RANKS, N_ITERS
    print(f"tensor {dims}, Tucker ranks {ranks}, device {device}")
    x = problem(device)

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
    # distributed grid selection over the Multi-TTM sweep objective
    for procs in (4, 8):
        choice = select_tucker_grid(dims, ranks, procs)
        print(f"  P={procs}: sweep-optimal grid {choice.grid} "
              f"({choice.words:,.0f} words/processor/sweep; model "
              f"{multi_ttm_sweep_words(dims, ranks, choice.grid):,.0f})")
    # ... and the distributed HOOI itself, on ranks of their own
    run_ranks(args.procs, device)

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
