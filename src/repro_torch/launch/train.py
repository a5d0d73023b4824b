"""Training launcher, the port of ``repro/launch/train.py``: a real
training job on one device with the full substrate (deterministic data,
async checkpointing, restart recovery, straggler monitoring).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch mamba2-2.7b --smoke --steps 200 --batch 8 --seq 128

It runs on the card unless ``--device cpu`` asks for the host. The
reference's ``--mesh debug`` waits for the mesh layer (ROADMAP Queue 1
item 15f).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import tempfile
import time


def main(argv=None):
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
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M model for examples)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..configs import get_config, get_smoke
    from ..data import DataConfig, synthetic_batch
    from ..engine.context import check_device
    from ..optim.schedule import cosine_schedule
    from ..training import LoopConfig, TrainLoop, build_train_step, init_train_state

    dev = check_device(args.device, "launch.train")
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.d_model:
        cfg = dataclasses.replace(cfg, d_model=args.d_model)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)

    state = init_train_state(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    n_params = sum(p.numel() for p in state.params.parameters())
    devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"arch={cfg.name} params={n_params:,} devices={devices}")

    def lr_fn(s):
        return cosine_schedule(s, args.lr, 20, args.steps)
    step = build_train_step(cfg, microbatches=args.microbatches, lr_fn=lr_fn)
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
    t0 = time.time()
    state, stats = loop.run(state)
    dt = time.time() - t0
    print(
        f"done: {stats.steps_done} steps in {dt:.1f}s "
        f"({dt / max(stats.steps_done, 1):.3f}s/step), "
        f"loss {stats.losses[0]:.4f} -> {stats.losses[-1]:.4f}, "
        f"restarts={stats.restarts} stragglers={stats.stragglers}"
    )
    return stats


if __name__ == "__main__":
    main()
