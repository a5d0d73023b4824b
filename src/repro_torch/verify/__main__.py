"""``python -m repro_torch.verify`` — the static verification gate.
Counterpart of ``python -m repro.verify``, with its flags, output and exit
codes.

Runs the five analyzers (plan verifier, kernel coverage analyzer, the
port's lint, communication verifier, dtype-flow analyzer) and exits
nonzero on any finding, so CI can gate on it::

    PYTHONPATH=src python -m repro_torch.verify                # all analyzers
    PYTHONPATH=src python -m repro_torch.verify --only lint    # subset
    PYTHONPATH=src python -m repro_torch.verify --comm --dtypes  # selectors
    PYTHONPATH=src python -m repro_torch.verify --rules        # lint catalog
    PYTHONPATH=src python -m repro_torch.verify --trace-out v.jsonl

``--comm`` / ``--dtypes`` are shorthand selectors for the distributed
analyzers (equivalent to ``--only comm,dtypes``); they compose with each
other and with ``--only``.

``--trace-out`` records one ``kind="static_verify"`` span event per
verdict (kernel plan, kernel walk, comm point, dtype program) plus one
summary event, in the ``repro_torch.observe`` span schema, so
``python -m repro_torch.observe.report`` tables them, the comm points with
their modeled, bound and counted byte columns.

Exit status: 0 = clean; 1 = at least one finding; 2 = bad usage.
"""

from __future__ import annotations

import argparse
import sys

from . import Finding

ANALYZERS = ("plans", "kernels", "lint", "comm", "dtypes")


def run(only: tuple[str, ...] = ANALYZERS,
        trace_out: str | None = None) -> tuple[list[Finding], list[dict]]:
    """Run the selected analyzers; returns (findings, verdicts) and
    optionally exports the verdicts as a JSONL trace. Every verdict dict
    carries an ``"analyzer"`` key (``"plans"`` for a kernel plan,
    ``"kernels"`` / ``"comm"`` / ``"dtypes"``)."""
    findings: list[Finding] = []
    verdicts: list[dict] = []
    if "plans" in only:
        from .plans import kernel_plan_verdicts, verify_plans

        findings += verify_plans()
        kf, kv = kernel_plan_verdicts()
        findings += kf
        verdicts += kv
    if "kernels" in only:
        from .kernels import verify_kernels

        kf, kv = verify_kernels()
        findings += kf
        verdicts += kv
    if "lint" in only:
        from .lint import lint_tree

        findings += lint_tree()
    if "comm" in only:
        from .comm import verify_comm

        cf, cv = verify_comm()
        findings += cf
        verdicts += cv
    if "dtypes" in only:
        from .dtypes import verify_dtypes

        df, dv = verify_dtypes()
        findings += df
        verdicts += dv
    if trace_out is not None:
        from ..observe.trace import Trace, record_event

        def of(analyzer: str) -> list[dict]:
            return [v for v in verdicts if v["analyzer"] == analyzer]

        with Trace(path=trace_out):
            for v in verdicts:
                record_event("static_verify", **v)
            record_event(
                "static_verify",
                name="summary",
                analyzers=list(only),
                findings=len(findings),
                kernel_plans_checked=len(of("plans")),
                kernel_plans_agreeing=sum(1 for v in of("plans") if v["agrees"]),
                kernels_checked=len(of("kernels")),
                kernels_agreeing=sum(1 for v in of("kernels") if v["agrees"]),
                comm_points=len(of("comm")),
                dtype_programs=len(of("dtypes")),
            )
    return findings, verdicts


def _print_verdict(v: dict) -> None:
    mark = "ok" if v["agrees"] and not v.get("findings") else "FAIL"
    if v["analyzer"] == "plans":
        problem = (f"kernel plan {v['name']}: shape={tuple(v['shape'])} rank={v['rank']} "
                   f"itemsize={v['itemsize']} batch={v['batch']}")
        if v["plan"] is None:
            print(f"{problem} no plan [{mark}]")
        else:
            print(f"{problem} {v['plan']} smem={v['smem_bytes']} launch={tuple(v['launch'])} "
                  f"[{mark}]")
    elif v["analyzer"] == "kernels":
        print(f"kernel {v['name']}: shape={tuple(v['shape'])} batch={v['batch']} "
              f"grid={tuple(v['grid'])} smem={v['smem_bytes']} "
              f"writes={v['writes_checked']} max_count={v['max_count']} [{mark}]")
    elif v["analyzer"] == "comm":
        if "measured_collective_bytes" in v:
            print(f"comm {v['name']}: shape={tuple(v['shape'])} grid={tuple(v['grid'])} "
                  f"bytes={v['measured_collective_bytes']} model={v['modeled_words']}w "
                  f"lb={v['lower_bound_words']}w [{mark}]")
        else:
            print(f"comm {v['name']}: [{mark}]")
    else:  # dtypes
        print(f"dtypes {v['name']}: {v['accumulations']} accumulation(s), "
              f"{v['narrow_accumulations']} narrow [{mark}]")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.verify", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--only", default=None,
                    help=f"comma-separated analyzers to run (default: {','.join(ANALYZERS)})")
    ap.add_argument("--comm", action="store_true",
                    help="run the communication verifier (selector shorthand)")
    ap.add_argument("--dtypes", action="store_true",
                    help="run the dtype-flow analyzer (selector shorthand)")
    ap.add_argument("--rules", action="store_true",
                    help="print the lint rule catalog (markdown) and exit")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write verdicts as kind=static_verify JSONL span events "
                    "(repro_torch.observe schema)")
    args = ap.parse_args(argv)

    if args.rules:
        from .lint import rule_catalog

        print(rule_catalog())
        return 0

    selected: list[str] = []
    if args.only:
        selected += [a.strip() for a in args.only.split(",") if a.strip()]
    if args.comm and "comm" not in selected:
        selected.append("comm")
    if args.dtypes and "dtypes" not in selected:
        selected.append("dtypes")
    bad = [a for a in selected if a not in ANALYZERS]
    if bad:
        print(f"verify: unknown analyzer(s) {bad}; choose from {ANALYZERS}", file=sys.stderr)
        return 2
    only = tuple(selected) if selected else ANALYZERS

    findings, verdicts = run(only, trace_out=args.trace_out)
    for f in findings:
        print(f)
    for v in verdicts:
        _print_verdict(v)
    by = {a: sum(1 for v in verdicts if v["analyzer"] == a)
          for a in ("plans", "kernels", "comm", "dtypes")}
    print(f"verify: {len(findings)} finding(s) across {', '.join(only)}; "
          f"{by['plans']} kernel plan(s), {by['kernels']} kernel(s), "
          f"{by['comm']} comm point(s), {by['dtypes']} dtype program(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
