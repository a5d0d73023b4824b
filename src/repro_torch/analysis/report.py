"""Render the dry run's markdown tables from its records, the port of
``repro/analysis/report.py``, for the H100:

    PYTHONPATH=src python -m repro_torch.analysis.report [--dir results/dryrun_torch]

"fits" holds a device's peak against the card's 80 GB and the roofline
fraction uses ``H100.peak_flops["bfloat16"]``: the data sheet's figures
(:data:`~repro_torch.analysis.roofline.H100`), not readings. A record of a
cut model (``run_cell(layers=)``) names its depth beside its arch.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from .roofline import H100, roofline_from_record

HBM_BYTES = 80 * 10 ** 9  # the H100's 80 GB (data sheet)
PEAK = H100.peak_flops["bfloat16"]


def load(results_dir: str) -> list[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def arch_name(r: dict) -> str:
    """The record's arch, with its depth where the model was cut."""
    return f"{r['arch']} [n_layers={r['n_layers']}]" if "n_layers" in r else r["arch"]


def fmt_t(x: float) -> str:
    return f"{x * 1e3:.2f}ms" if x >= 1e-4 else f"{x * 1e6:.0f}us"


def dryrun_table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | status | mem/dev | fits H100 | FLOPs/dev "
        "| op bytes/dev | coll bytes/dev | collectives |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        cell = f"| {arch_name(r)} | {r['shape']} | {r['mesh']} "
        if r.get("status") == "skipped":
            lines.append(cell + "| skip | – | – | – | – | – | – |")
            continue
        if r.get("status") != "ok":
            lines.append(cell + "| ERROR | – | – | – | – | – | – |")
            continue
        mem = r["memory"]["peak_bytes_est"]
        kinds = r["collectives"]["by_kind"]
        ks = ",".join(
            f"{k.replace('all-', 'a').replace('reduce-scatter', 'rs')}×{v['count']}"
            for k, v in sorted(kinds.items())
        )
        lines.append(
            cell
            + f"| ok | {mem / 2**30:.1f}GiB "
            + f"| {'Y' if mem <= HBM_BYTES else 'N'} "
            + f"| {r['cost']['flops']:.2e} | {r['cost']['bytes_accessed']:.2e} "
            + f"| {r['collectives']['operand_bytes']:.2e} | {ks} |"
        )
    return "\n".join(lines)


def _fraction(r: dict, rt) -> float:
    """Model-flops time over the overlapped step bound."""
    ideal = rt.model_flops_total / (r["devices"] * PEAK)
    return ideal / rt.step_time_overlapped if rt.step_time_overlapped else 0


def roofline_table(recs: list[dict], mesh: str = "16x16") -> str:
    lines = [
        "| arch | shape | T_comp | T_mem | T_coll | bottleneck | "
        "useful (6ND/FLOPs) | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != mesh or r.get("status") != "ok":
            continue
        rt = roofline_from_record(r)
        lines.append(
            f"| {arch_name(r)} | {r['shape']} | {fmt_t(rt.t_compute)} "
            f"| {fmt_t(rt.t_memory)} | {fmt_t(rt.t_collective)} "
            f"| **{rt.bottleneck}** | {rt.useful_ratio:.2f} | {_fraction(r, rt):.3f} |"
        )
    return "\n".join(lines)


def pick_hillclimb(recs: list[dict]) -> list[tuple]:
    """(cell, reason) candidates: worst roofline fraction, most
    collective-bound."""
    scored = []
    for r in recs:
        if r.get("mesh") != "16x16" or r.get("status") != "ok":
            continue
        rt = roofline_from_record(r)
        coll_ratio = rt.t_collective / max(rt.step_time_overlapped, 1e-30)
        scored.append((r, _fraction(r, rt), coll_ratio))
    if not scored:
        return []
    worst = min(scored, key=lambda s: s[1] if s[1] > 0 else 1e9)
    most_coll = max(scored, key=lambda s: s[2])
    return [
        (f"{arch_name(worst[0])}|{worst[0]['shape']}",
         f"worst roofline fraction {worst[1]:.3f}"),
        (f"{arch_name(most_coll[0])}|{most_coll[0]['shape']}",
         f"most collective-bound (T_coll/T = {most_coll[2]:.2f})"),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print("## Dry-run matrix\n")
    print(dryrun_table(recs))
    print(f"\n## Roofline ({args.mesh}, {H100.name})\n")
    print(roofline_table(recs, args.mesh))
    print("\n## Hillclimb candidates\n")
    for cell, why in pick_hillclimb(recs):
        print(f"- {cell}: {why}")


if __name__ == "__main__":
    main()
