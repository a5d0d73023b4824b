"""Training launcher, the port of ``repro/launch/train.py``: a real
training job with the full substrate (deterministic data, async
checkpointing, restart recovery, straggler monitoring).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch mamba2-2.7b --smoke --steps 200 --batch 8 --seq 128

It runs on the card unless ``--device cpu`` asks for the host.
``--mesh debug`` trains on the 2 x 4 debug mesh
(:func:`repro_torch.launch.mesh.make_debug_mesh`) with
``make_policy(cfg, mesh)`` and the sharded step (``jit_train_step``), on 8
ranks: run as above, the launcher starts the 8 ranks itself (gloo on
``--device cpu``, NCCL with one card a rank on ``cuda``, which needs 8
cards), and rank 0 prints; under ``torch.distributed.run`` (``WORLD_SIZE``
set) each process is one rank of the group that tool opened.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import queue
import socket
import tempfile
import time

#: Ranks of the debug mesh (2 x 4).
DEBUG_RANKS = 8


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["none", "debug"], default="none")
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M model for examples)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse(argv)
    if args.mesh == "debug" and "WORLD_SIZE" not in os.environ:
        return _spawn(argv)
    return _train(args)


def _train(args, rank_of: tuple[int, int] | None = None):
    """The job in this process: alone (``--mesh none``), or as one rank of
    the debug mesh's group (``rank_of`` = (rank, port) from :func:`_spawn`,
    else the group ``torch.distributed.run`` describes in the
    environment). Returns rank 0's stats (None on the other ranks)."""
    import torch

    from ..configs import get_config, get_smoke
    from ..data import DataConfig, synthetic_batch
    from ..engine.context import check_device
    from ..optim.schedule import cosine_schedule
    from ..training import (
        LoopConfig,
        TrainLoop,
        init_train_state,
        jit_train_step,
        train_state_specs,
    )

    dev = check_device(args.device, "launch.train")
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.d_model:
        cfg = dataclasses.replace(cfg, d_model=args.d_model)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)

    mesh = None
    rank, world = 0, 1
    if args.mesh == "debug":
        dev, rank = _join(dev, rank_of)
        world = DEBUG_RANKS
    try:
        from ..launch.mesh import make_debug_mesh
        from ..models.sharding import NULL, make_policy

        if args.mesh == "debug":
            mesh = make_debug_mesh(device_type=dev.type)
        sh = make_policy(cfg, mesh) if mesh is not None else NULL
        state = init_train_state(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                                 device=dev)
        n_params = sum(p.numel() for p in state.params.parameters())
        devices = world if mesh is not None else (
            torch.cuda.device_count() if dev.type == "cuda" else 1)
        if rank == 0:
            print(f"arch={cfg.name} params={n_params:,} devices={devices}", flush=True)

        def lr_fn(s):
            return cosine_schedule(s, args.lr, 20, args.steps)
        step = jit_train_step(cfg, sh, state, args.microbatches, lr_fn=lr_fn)
        data_cfg = DataConfig(
            vocab_size=cfg.vocab_size, seq_len=args.seq,
            global_batch=args.batch, seed=0,
        )
        loop = TrainLoop(
            step, data_cfg,
            LoopConfig(
                total_steps=args.steps, ckpt_every=args.ckpt_every,
                ckpt_dir=args.ckpt_dir,
            ),
            batch_fn=functools.partial(synthetic_batch, device=dev),
        )
        spec_tree = train_state_specs(state, cfg, sh) if mesh is not None else None
        t0 = time.time()
        state, stats = loop.run(state, mesh=mesh, spec_tree=spec_tree)
        dt = time.time() - t0
        if rank != 0:
            return None
        print(
            f"done: {stats.steps_done} steps in {dt:.1f}s "
            f"({dt / max(stats.steps_done, 1):.3f}s/step), "
            f"loss {stats.losses[0]:.4f} -> {stats.losses[-1]:.4f}, "
            f"restarts={stats.restarts} stragglers={stats.stragglers}", flush=True
        )
        return stats
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _join(dev, rank_of):
    """Open this rank's process group of DEBUG_RANKS (gloo on the host,
    NCCL on a card of its own); returns (device, rank)."""
    import torch
    import torch.distributed as dist

    backend = "nccl" if dev.type == "cuda" else "gloo"
    if rank_of is None:  # torch.distributed.run gave the group in the environment
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if world != DEBUG_RANKS:
            raise ValueError(f"--mesh debug runs on {DEBUG_RANKS} ranks; WORLD_SIZE is {world}")
        init = "env://"
    else:
        rank, port = rank_of
        init = f"tcp://localhost:{port}"
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    else:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // DEBUG_RANKS))
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=DEBUG_RANKS)
    return dev, rank


def _rank_main(argv, rank: int, port: int, results) -> None:
    """One rank started by :func:`_spawn`: rank 0 puts its losses on
    ``results``."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    stats = _train(_parse(argv), (rank, port))
    if rank == 0:
        results.put(list(stats.losses))


def _spawn(argv):
    """``--mesh debug`` started alone: DEBUG_RANKS processes of this
    launcher, one a rank (on ``cuda`` one card each). Returns rank 0's
    stats: an object with its ``losses``."""
    import multiprocessing as mp

    from ..engine.context import check_device

    args = _parse(argv)
    dev = check_device(args.device, "launch.train")
    if dev.type == "cuda":
        import torch

        if torch.cuda.device_count() < DEBUG_RANKS:
            raise RuntimeError(f"--mesh debug on --device cuda needs {DEBUG_RANKS} cards, one "
                               f"a rank; this host has {torch.cuda.device_count()}")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(argv, r, port, results))
             for r in range(DEBUG_RANKS)]
    for p in procs:
        p.start()
    losses = None
    try:
        while losses is None:
            try:
                losses = results.get(timeout=1.0)
            except queue.Empty:
                # a rank that fails leaves the others waiting in a collective
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
    finally:
        for p in procs:
            p.join(timeout=None if losses is not None else 0)
            if p.is_alive():
                p.kill()
                p.join()
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if failed or losses is None:
        raise RuntimeError(f"--mesh debug: ranks exited {failed}")
    return argparse.Namespace(losses=losses)


if __name__ == "__main__":
    main()
