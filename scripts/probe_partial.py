#!/usr/bin/env python3
"""The streaming partial kernel's device time per plan, at the nodes the main
paths give it.

    python3 scripts/probe_partial.py [--seed N] [--quick]

Needs one CUDA card and nvcc. ``mttkrp_partial`` (``csrc/sweep.cu``,
``streaming_partial_kernel``) contracts a rank-carrying node with its
dropped factors, reading the node in place through its strides. The nodes
are the ones ``contract_partial`` hands it in ``chip_smoke.py``'s CP-ALS
runs, each as that view (``in_place``) and as its canonical copy
(``canonical``): the fused sweep's P at 1000^3, R=64 for mode 1 (k=1) and at
180^4, R=32 for modes 1 and 2 (k=2, fp32 and bf16), the 3-way dimension
tree's (1000, 1000, 64) leaves and the 4-way tree's (180, 180, 32) leaves.

At each node: the default plan (``choose_partial_kernel_blocks``) and, unless
``--quick``, the default with the splits that fill at least one wave
(``n_splits``) and two, and every other plan of both layouts with 1, 2, 4
or 8 rows a thread and 4 or 8 loads in flight, its splits by the default's
rule (``one_wave_splits``). Every
plan is checked against ``mttkrp_partial_plain`` (1e-5 of the largest
magnitude; bf16 nodes against the fp32 plain version within 2e-2) before it
is timed as device time by CUDA graphs (``chip_smoke.graph_ms``), the
split-K reduction included; ``torch.einsum`` is timed the same way, and the
bytes bound (``repro_torch.analysis.roofline.bound``) is given beside. JSON lines with the
card's name and power limit, after the compiler's register and spill count
of each kernel instantiation.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def nodes(gen):
    """``(where, node, factors, perm, dtype)``: the node as the sweep or
    tree holds it (fp32 unless bf16), the dropped factors of its axes and
    the permute ``contract_partial`` makes (kept modes first)."""
    import torch

    def factors(dims, rank):
        return [torch.randn((d, rank), generator=gen, device="cuda") / rank ** 0.5 for d in dims]

    out = []
    node = torch.randn((1000, 1000, 64), generator=gen, device="cuda")
    fs = factors((1000, 1000), 64)
    out.append(("fused 3-way mode 1, k=1", node, fs, (1, 0, 2), "float32"))
    out.append(("dimtree 3-way leaf 1, k=1", node, fs, (0, 1, 2), "float32"))
    node = torch.randn((180, 180, 180, 32), generator=gen, device="cuda")
    fs = factors((180, 180, 180), 32)
    for perm, mode in (((1, 0, 2, 3), 1), ((2, 0, 1, 3), 2)):
        out.append((f"fused 4-way mode {mode}, k=2", node, fs, perm, "float32"))
        out.append((f"fused 4-way mode {mode}, k=2", node, fs, perm, "bfloat16"))
    node = torch.randn((180, 180, 32), generator=gen, device="cuda")
    fs = factors((180, 180), 32)
    out.append(("dimtree 4-way leaf 0, k=1", node, fs, (0, 1, 2), "float32"))
    out.append(("dimtree 4-way leaf 1, k=1", node, fs, (1, 0, 2), "float32"))
    return out


def variants(default, rank: int, shape, nkeep: int, sms: int):
    """The default with the splits of ``n_splits`` (at least one full wave
    of ``CTAS_PER_SM`` CTAs an SM, so perhaps a second, nearly empty one)
    and of two full waves; then every plan of both layouts with 1-8 rows a
    thread and 4 or 8 loads, the default's vector width, its splits by the
    default's rule (``one_wave_splits``)."""
    from repro_torch.engine.plan import (
        PartialKernelPlan,
        n_splits,
        one_wave_splits,
        partial_kernel_grid,
        partial_kernel_threads,
    )

    tl = partial_kernel_threads(rank, default.vec)[1]
    blocks, rtiles, units = partial_kernel_grid(shape, rank, default, nkeep)
    ctas = blocks * rtiles
    seen = {default}
    for splits in (n_splits(ctas, units, sms), n_splits(ctas, units, 2 * sms)):
        plan = PartialKernelPlan(default.layout, default.block_rows, default.vec,
                                 default.loads, min(splits, 65535))
        if plan not in seen:
            seen.add(plan)
            yield plan
    for layout in ("rows", "contract"):
        for rows in (1, 2, 4, 8):
            for loads in (4, 8):
                if loads < rows:
                    continue
                block = rows * (tl if layout == "rows" else 1)
                plan = PartialKernelPlan(layout, block, default.vec, loads, 1)
                blocks, rtiles, units = partial_kernel_grid(shape, rank, plan, nkeep)
                plan = PartialKernelPlan(layout, block, default.vec, loads,
                                         one_wave_splits(blocks * rtiles, units, sms))
                if plan not in seen:
                    seen.add(plan)
                    yield plan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true", help="the default plans only")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_partial: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from chip_smoke import TOL, graph_ms, nvidia_smi, rel_err
    from repro_torch.analysis.roofline import bound
    from repro_torch.engine.plan import choose_partial_kernel_blocks
    from repro_torch.kernels import build
    from repro_torch.kernels.partial import mttkrp_partial, mttkrp_partial_plain, node_view

    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = nvidia_smi()
    _, log = build.build("sweep.cu")
    current = None
    for line in log.splitlines():
        m = re.search(r"streaming_partial_kernel\w*", line)
        if m and "Compiling entry" in line:
            current = m.group(0)
        regs = re.search(r"Used (\d+) registers", line)
        if current and regs:
            print(json.dumps({"kernel": current, "registers": int(regs.group(1)), "gpu": gpu}))
            current = None
        spill = re.search(r"(\d+) bytes spill stores", line)
        if current and spill and int(spill.group(1)):
            print(json.dumps({"kernel": current, "spill_bytes": int(spill.group(1))}))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for where, node32, fs32, perm, dtype in nodes(gen):
        cast = getattr(torch, dtype)
        node, fs = node32.to(cast), [f.to(cast) for f in fs32]
        fsp = [fs[a] for a in perm[1:-1]]
        want = mttkrp_partial_plain(node32.permute(perm), [fs32[a] for a in perm[1:-1]])
        rank, k = node.shape[-1], len(fsp)
        letters = "abcdefg"[:node.ndim - 1]
        spec = f"{letters}z," + ",".join(f"{c}z" for c in letters[1:]) + "->az"
        for how in ("in_place", "canonical"):
            view = node.permute(perm)
            if how == "canonical":
                view = view.contiguous()
            nkeep = view.ndim - 1 - k
            ks, kst, cs, cst, _ = node_view(view, nkeep)
            aligned = view.data_ptr() % 16 == 0
            default = choose_partial_kernel_blocks((*ks, *cs), (*kst, *cst), rank,
                                                   view.element_size(), sms, nkeep=len(ks),
                                                   aligned=aligned)
            ctot = math.prod(cs)
            b_ms, b_by = bound(view.numel(), view.element_size(), sum(f.numel() for f in fsp),
                               view.shape[0] * rank, 2.0 * view.numel() + (k - 1) * ctot * rank,
                               "float32")
            lib_ms = graph_ms(lambda: torch.einsum(spec, view, *fsp), reps=20, rounds=3)
            plans = [default] + ([] if args.quick else list(
                variants(default, rank, (*ks, *cs), len(ks), sms)))
            for plan in plans:
                got = mttkrp_partial(view, fsp, plan=plan)
                rel, diff = rel_err(got, want)
                ok = bool(torch.isfinite(got).all()) and rel <= TOL[dtype]
                rec = {"node": where, "view": how, "shape": list(view.shape),
                       "strides": list(view.stride()), "dtype": dtype, "default": plan == default,
                       "plan": [plan.layout, plan.block_rows, plan.vec, plan.loads, plan.splits],
                       "max_rel_err": rel, "max_abs_err": diff, "ok": ok,
                       "graph_ms": graph_ms(lambda: mttkrp_partial(view, fsp, plan=plan),
                                            reps=20, rounds=3) if ok else None,
                       "einsum_graph_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by, "gpu": gpu}
                print(json.dumps(rec), flush=True)
                if not ok:
                    raise AssertionError(f"probe_partial: {json.dumps(rec)}")
            del view
        del node, fs, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
