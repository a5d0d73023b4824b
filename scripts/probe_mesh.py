#!/usr/bin/env python3
"""Which models' sharded paths run on this machine's PyTorch, on a (1, 1)
``("data", "model")`` CUDA mesh of a world-size-1 NCCL group.

    python3 scripts/probe_mesh.py [--dtype float32|bfloat16] [--policy k=v ...] [NAME ...]

Needs one CUDA card (and nvcc, for ``ssd_intra``). DTensor's sharding
rules differ between PyTorch releases, so a path that runs sharded on one
release may meet an op without a rule on another. For each smoke config
(default all ten), from one seed: one ``jit_train_step`` against one
``build_train_step``, a ``forward`` prefill and 2 ``jit_serve_step``
decode steps (``cache_specs``) against the unsharded ``forward`` and
``decode_step`` (the encoder-decoder model's with ``cross_kv``), under
``make_policy`` with the fields ``--policy`` names replaced (say
``attn=context`` and ``moe=ffn``, the paths a (1, 1) mesh would not
take). One JSON
line a config: each part's relative difference from the unsharded run,
or the error it raised (its type, message and innermost frame in
``repro_torch``); then one line with the card's name and power limit and
the versions.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _where(exc: BaseException) -> str:
    """The innermost frame of ``exc``'s traceback inside ``repro_torch``."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__) if "repro_torch" in f.filename]
    return f"{os.path.relpath(frames[-1].filename, ROOT)}:{frames[-1].lineno}" if frames else ""


def _rel(got, want) -> float:
    from repro_torch.models.sharding import full

    got, want = full(got).float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def probe(name: str, dtype: str, mesh, policy: dict) -> dict:
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.models import forward, init_decode_state, make_policy
    from repro_torch.models.model import _encoder_kv
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.blocks import apply_stack
    from repro_torch.training import (build_serve_step, build_train_step, init_train_state,
                                      jit_serve_step, jit_train_step)

    cfg = replace(get_smoke(name), dtype=dtype)
    sh = replace(make_policy(cfg, mesh), **policy)
    b, s = 2, 16
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {}
    if cfg.frontend != "none":
        batch["embeds"] = torch.randn(b, s, cfg.d_model, generator=gen, device="cuda").to(
            getattr(torch, dtype))
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    labels = "dec_labels" if cfg.is_encdec else "labels"
    if cfg.is_encdec:
        batch["dec_tokens"] = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    batch[labels] = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (b, 2), generator=gen, device="cuda")
    out: dict = {"name": name, "dtype": dtype, "attn": sh.attn, "moe": sh.moe}

    def part(key, fn):
        try:
            out[key] = fn()
        except Exception as exc:  # noqa: BLE001 - a probe records what each part raised
            out[key] = {"error": f"{type(exc).__name__}: {str(exc)[:300]}", "at": _where(exc)}

    def state():
        return init_train_state(cfg, generator=torch.Generator(device="cuda").manual_seed(0))

    def train():
        _, want = build_train_step(cfg)(state(), batch)
        s0 = state()
        _, got = jit_train_step(cfg, sh, s0)(s0, batch)
        return abs(float(got["loss"]) - float(want["loss"])) / abs(float(want["loss"]))

    params = state().params

    def prefill():
        mode = "train" if cfg.is_encdec else "prefill"
        want, _ = forward(params, cfg, batch, mode=mode, logits_positions="last")
        got, _ = forward(params, cfg, batch, mode=mode, logits_positions="last", sh=sh)
        return _rel(got, want)

    def decode():
        cross = None
        if cfg.is_encdec:
            with torch.no_grad():
                enc, _ = apply_stack(params.encoder, batch["embeds"], cfg,
                                     torch.arange(s, device="cuda").expand(b, s), causal=False)
                cross = _encoder_kv(cfg, apply_norm(params.enc_norm, enc))
        plain, meshed = init_decode_state(params, cfg, b, 4), init_decode_state(params, cfg, b, 4)
        serve, mesh_serve = build_serve_step(cfg), jit_serve_step(cfg, sh, params, meshed)
        errs = []
        for i in range(2):
            tok = tokens[:, i:i + 1]
            if cross is None:
                want, plain = serve(params, plain, tok)
                got, meshed = mesh_serve(params, meshed, tok)
            else:
                from repro_torch.models import decode_step

                want, plain = decode_step(params, cfg, plain, tok, cross)
                got, meshed = decode_step(params, cfg, meshed, tok, cross, sh=sh)
            errs.append(_rel(got, want))
        return max(errs)

    part("train_rel_loss", train)
    part("prefill_rel", prefill)
    part("decode_rel", decode)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--policy", action="append", default=[], metavar="K=V",
                    help="a field of the sharding policy replaced (attn=context, moe=ffn)")
    args = ap.parse_args()
    policy = dict(kv.split("=", 1) for kv in args.policy)

    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("probe_mesh: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.launch.mesh import make_debug_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        for name in args.names or ARCH_NAMES:
            print(json.dumps(probe(name, args.dtype, mesh, policy)), flush=True)
    finally:
        dist.destroy_process_group()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
