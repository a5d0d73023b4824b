"""Distributed CP-ALS with the paper's parallel MTTKRP algorithms, on the
PyTorch/CUDA port (``torch.distributed``).

The steps of ``examples/cp_parallel.py``, as an SPMD program: this script
starts its own ranks (``--procs``, 4 or 8), each a process that joins one
gloo group (NCCL where every rank has a card of its own) and runs:

1. Automatic grid selection: ``grid_select`` minimizes the Eq (12)/(16)
   per-processor communication exactly.
2. The stationary CP-ALS sweep: X block-distributed over the selected grid,
   each factor gathered once a sweep; one sweep's collective bytes,
   counted at the collective wrappers, against the sweep model and against
   N independent Alg-3 calls; then ``repro_torch.cp_als`` on the
   distributed context.
3. Single-mode Algorithm 4 (rank-partitioned), its bytes against Eq (16).

Rank 0 prints. Ranks run on ``cuda:{rank % device_count}`` (several ranks
share a card over gloo) unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_cp_parallel.py [--procs 8] [--device cpu]
"""

import argparse
import os
import subprocess
import sys
import tempfile

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)

import torch
import torch.distributed as dist

import repro_torch
from repro_torch.core.bounds import par_general_cost, par_stationary_cost
from repro_torch.core.mttkrp import mttkrp
from repro_torch.core.tensor import (
    frob_norm,
    random_factors,
    random_low_rank_tensor,
    relative_error,
    tensor_from_factors,
)
from repro_torch.distributed import (
    COUNTER,
    build_cp_sweep,
    choose_cp_grid,
    make_grid_mesh,
    mttkrp_general,
    output_block,
    place_cp_state,
    place_inputs,
    ring_total,
    select_grid,
    stationary_sweep_words,
)
from repro_torch.distributed.collectives import all_reduce


def say(*args):
    if dist.get_rank() == 0:
        print(*args, flush=True)


def grid_selection_demo(dims, rank):
    procs = dist.get_world_size()
    choice = choose_cp_grid(dims, rank, procs)
    say(f"sweep-optimal grid for {dims}, R={rank}, P={procs}: "
        f"{'x'.join(map(str, choice.grid))} ({choice.words:.0f} words/processor/sweep)")
    big = select_grid(dims, 4096, 512, algorithm="auto", mode=0)
    say(f"large-NR regime (R=4096, P=512): Alg {'4' if big.p0 > 1 else '3'} with "
        f"p0={big.p0}, grid {'x'.join(map(str, big.grid))}\n")
    return choice


def sweep_driver_demo(x, rank, choice, device):
    dims, ndim = tuple(x.shape), x.ndim
    # one ExecutionContext carries the distributed setup; for_problem
    # resolves and validates the grid, and round-trips through JSON
    ctx = repro_torch.ExecutionContext.for_problem(dims, rank, backend="cuda", device=device,
                                                   distributed=True,
                                                   procs=dist.get_world_size())
    say(f"context grid: {'x'.join(map(str, ctx.distribution.grid))} (round-trips via "
        f"to_json: {repro_torch.ExecutionContext.from_json(ctx.to_json()) == ctx})")
    mesh = ctx.build_mesh(dims, rank)
    # one sweep's collective bytes, counted at the collective wrappers
    sweep = build_cp_sweep(mesh, ndim, ctx=ctx)
    gen = torch.Generator(device=device).manual_seed(1)
    xs, fs, blocks, grams = place_cp_state(mesh, x, random_factors(gen, dims, rank))
    normx = torch.sqrt(all_reduce(frob_norm(xs) ** 2, mesh.grid_group()))
    before = COUNTER.snapshot()
    sweep(xs, fs, blocks, grams, normx)
    measured = ring_total(COUNTER.delta(before))
    model = stationary_sweep_words(dims, rank, choice.grid) * 4
    indep = sum(par_stationary_cost(dims, rank, choice.grid, m) for m in range(ndim)) * 4
    say(f"per-sweep collective bytes: measured {measured}B, model {model:.0f}B (+1 fit "
        f"all-reduce), N independent Eq(12) calls {indep:.0f}B")
    # the decomposition through the public driver, on the same context
    res = repro_torch.cp_als(x, rank, n_iters=20, ctx=ctx,
                             generator=torch.Generator(device=device).manual_seed(2))
    recon = tensor_from_factors(res.factors, res.weights)
    say(f"distributed CP-ALS: fit={res.final_fit:.5f}, recon rel-err="
        f"{float(relative_error(x.to(recon.device), recon)):.2e}\n")


def alg4_demo(x, rank, device):
    dims = tuple(x.shape)
    p0 = 2
    grid = (2, 2, 1) if dist.get_world_size() == 8 else (2, 1, 1)
    mesh = make_grid_mesh(grid, p0=p0, dims=dims, rank=rank, device=device)
    fs = random_factors(torch.Generator(device=device).manual_seed(3), dims, rank)
    ctx = repro_torch.ExecutionContext.create("cuda", device=device)
    say(f"Algorithm 4 (general, P0={p0}, grid {'x'.join(map(str, grid))}):")
    for mode in range(3):
        f4 = mttkrp_general(mesh, mode, 3, ctx=ctx)
        xs, fl = place_inputs(mesh, x, fs, mode, rank_axis=True)
        before = COUNTER.snapshot()
        got = f4(xs, *fl)
        measured = ring_total(COUNTER.delta(before))
        want = par_general_cost(dims, rank, grid, p0, mode) * 4
        # this rank's block of the sequential MTTKRP, in Alg 4's layout
        block = output_block(mttkrp(x, fs, mode), mesh, mode, rank_axis=True)
        err = float((got - block).abs().max())
        say(f"  mode {mode}: measured {measured}B vs Eq(16) {want:.0f}B, max|err|={err:.1e}")


def rank_main(rank: int, world: int, store: str, device: str) -> None:
    backend = "nccl" if device == "cuda" and torch.cuda.device_count() >= world else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dims, rank_cp = (16, 16, 16), 4
        x, _ = random_low_rank_tensor(torch.Generator(device=device).manual_seed(0), dims,
                                      rank_cp)
        say(f"ranks: {world} ({backend}); tensor {dims}, rank {rank_cp}\n")
        choice = grid_selection_demo(dims, rank_cp)
        sweep_driver_demo(x, rank_cp, choice, device)
        alg4_demo(x, rank_cp, device)
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=4, choices=(4, 8))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args.rank, args.procs, args.store, args.device)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the ranks on the host")
    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "GLOO_SOCKET_IFNAME": os.environ.get("GLOO_SOCKET_IFNAME", "lo")}
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--procs",
                                   str(args.procs), "--device", args.device, "--rank", str(r),
                                   "--store", os.path.join(tmp, "store")], env=env)
                 for r in range(args.procs)]
        try:
            codes = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(codes):
            raise SystemExit(f"a rank failed: exit codes {codes}")


if __name__ == "__main__":
    main()
