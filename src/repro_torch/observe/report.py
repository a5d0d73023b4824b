"""Render a JSONL trace into a markdown dispatch table. Counterpart of
``repro.observe.report``, copied: the same table, kinds and exit codes.

Usage:
    PYTHONPATH=src python -m repro_torch.observe.report TRACE.jsonl \\
        [--flag-factor 2.0] [--strict] [--kinds mttkrp,multi_ttm,...]

Reads a trace exported by :class:`repro_torch.observe.trace.Trace` and prints
one markdown table row per dispatch-like event, with the model /
measured / bound columns the paper's claims live in:

| # | kind | problem | backend | model (words) | bound (words) | measured (bytes) | x model | flag |

``x model`` is measured bytes over modeled bytes (events without a
measured side — ordinary dispatch spans — show ``-``; collective-sweep
and bounds-audit events have one).  Any event whose measured traffic
exceeds its model by more than ``--flag-factor`` (default 2.0) is
flagged ``!``; ``--strict`` turns flags into exit status 1.

Exit status: 0 = table rendered; 1 = empty table (nothing dispatch-like
in the trace — the CI smoke treats that as a broken pipeline) or, with
``--strict``, at least one flagged row; 2 = unreadable input.
"""

from __future__ import annotations

import argparse
import sys

#: Event kinds that are dispatch-like (one engine contraction or one
#: measured sweep/audit) and hence rows in the report. The port records
#: the CP sweep's collectives; no Tucker sweep or static verdict yet (ROADMAP
#: Queue 1 items 12 and 13): their kinds stay, so a trace of either renders
#: when they come.
DISPATCH_KINDS = (
    "mttkrp",
    "contract_partial",
    "multi_ttm",
    "fused_pair",
    "cp_sweep_collectives",
    "tucker_sweep_collectives",
    "bounds_audit",
    "static_verify",
)


def _problem(e: dict) -> str:
    shape = e.get("shape")
    rank = e.get("rank", e.get("ranks"))
    mode = e.get("mode", e.get("keep"))
    grid = e.get("grid")
    bits = []
    if shape is not None:
        bits.append("x".join(str(s) for s in shape))
    if rank is not None:
        bits.append(f"r={rank}")
    if mode is not None:
        bits.append(f"m={mode}")
    if grid is not None:
        bits.append(f"g={'x'.join(str(g) for g in grid)}")
    return " ".join(bits) or e.get("name", "-")


def _fmt(v, digits: int = 0) -> str:
    if v is None:
        return "-"
    if digits:
        return f"{float(v):.{digits}f}"
    return f"{float(v):,.0f}"


def render_rows(
    events: list[dict],
    *,
    flag_factor: float = 2.0,
    kinds: tuple[str, ...] = DISPATCH_KINDS,
) -> tuple[list[str], int]:
    """Markdown table lines for the dispatch-like events; returns
    ``(lines, flagged_count)``. Empty list = nothing dispatch-like."""
    rows: list[str] = []
    flagged = 0
    for e in events:
        kind = e.get("kind")
        if kind not in kinds:
            continue
        modeled = e.get("modeled_words")
        bound = e.get("lower_bound_words")
        measured = e.get(
            "measured_bytes", e.get("measured_collective_bytes")
        )
        itemsize = float(e.get("itemsize", 4))
        ratio = None
        if measured is not None and modeled:
            ratio = float(measured) / (float(modeled) * itemsize)
        flag = ""
        if ratio is not None and ratio > flag_factor:
            flag = "!"
            flagged += 1
        rows.append(
            f"| {e.get('seq', '-')} | {kind} | {_problem(e)} "
            f"| {e.get('backend', '-')} "
            f"| {_fmt(modeled)} | {_fmt(bound)} | {_fmt(measured)} "
            f"| {_fmt(ratio, 2) if ratio is not None else '-'} "
            f"| {flag} |"
        )
    return rows, flagged


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.observe.report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("trace", help="JSONL trace file (Trace(path=...))")
    ap.add_argument(
        "--flag-factor", type=float, default=2.0,
        help="flag rows whose measured bytes exceed modeled bytes by "
        "this factor (default 2.0)",
    )
    ap.add_argument(
        "--strict", action="store_true",
        help="exit 1 when any row is flagged",
    )
    ap.add_argument(
        "--kinds", default=None,
        help=f"comma-separated event kinds to table "
        f"(default: {','.join(DISPATCH_KINDS)})",
    )
    args = ap.parse_args(argv)
    from .trace import load_trace

    try:
        events = load_trace(args.trace)
    except (OSError, ValueError) as e:
        print(f"report: cannot read {args.trace}: {e}", file=sys.stderr)
        return 2
    kinds = (
        tuple(k.strip() for k in args.kinds.split(",") if k.strip())
        if args.kinds else DISPATCH_KINDS
    )
    rows, flagged = render_rows(
        events, flag_factor=args.flag_factor, kinds=kinds
    )
    if not rows:
        print(
            f"report: no dispatch events in {args.trace} "
            f"({len(events)} events total; kinds={kinds})",
            file=sys.stderr,
        )
        return 1
    print(
        "| # | kind | problem | backend | model (words) | bound (words) "
        "| measured (bytes) | x model | flag |"
    )
    print("|---|------|---------|---------|---------------|---------------"
          "|------------------|---------|------|")
    for r in rows:
        print(r)
    print(
        f"\n{len(rows)} dispatch(es), {flagged} flagged "
        f"(> {args.flag_factor}x model), {len(events)} events total."
    )
    if args.strict and flagged:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
