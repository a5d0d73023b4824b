"""``python -m repro_torch.verify`` — the static verification gate.
Counterpart of ``python -m repro.verify``, with its flags, output and exit
codes::

    PYTHONPATH=src python -m repro_torch.verify                # every ported analyzer
    PYTHONPATH=src python -m repro_torch.verify --only plans
    PYTHONPATH=src python -m repro_torch.verify --trace-out v.jsonl

Ported so far: ``plans`` (the reference's plan checks and the Hopper
kernels' plans, :mod:`repro_torch.verify.plans`). The reference's
``kernels``, ``lint``, ``comm`` and ``dtypes`` analyzers (``--only``,
``--comm``, ``--dtypes``, ``--rules``) are not ported yet (ROADMAP Queue 1
item 13): asking for one exits 2 and names it, and the summary names only
the analyzers that ran.

``--trace-out`` records one ``kind="static_verify"`` span event a kernel
plan checked plus one summary event, in the ``repro_torch.observe`` span
schema, so ``python -m repro_torch.observe.report`` tables them.

Exit status: 0 = clean; 1 = at least one finding; 2 = bad usage or an
analyzer that is not ported.
"""

from __future__ import annotations

import argparse
import sys

from . import Finding

ANALYZERS = ("plans", "kernels", "lint", "comm", "dtypes")
#: The analyzers this package runs; the rest wait for ROADMAP Queue 1 item 13.
PORTED = ("plans",)


def _not_ported(names) -> str:
    return (f"verify: analyzer(s) {list(names)} not ported to repro_torch yet "
            f"(ROADMAP Queue 1 item 13); ported: {list(PORTED)}")


def run(only: tuple[str, ...] = PORTED,
        trace_out: str | None = None) -> tuple[list[Finding], list[dict]]:
    """Run the selected analyzers; returns (findings, verdicts) and
    optionally exports the verdicts as a JSONL trace. Raises
    ``ValueError`` for an analyzer that is not ported."""
    missing = [a for a in only if a not in PORTED]
    if missing:
        raise ValueError(_not_ported(missing))
    findings: list[Finding] = []
    verdicts: list[dict] = []
    if "plans" in only:
        from .plans import kernel_plan_verdicts, verify_plans

        findings += verify_plans()
        kf, verdicts = kernel_plan_verdicts()
        findings += kf
    if trace_out is not None:
        from ..observe.trace import Trace, record_event

        with Trace(path=trace_out):
            for v in verdicts:
                record_event("static_verify", **v)
            record_event(
                "static_verify",
                name="summary",
                analyzers=list(only),
                not_ported=[a for a in ANALYZERS if a not in PORTED],
                findings=len(findings),
                kernel_plans_checked=len(verdicts),
                kernel_plans_agreeing=sum(1 for v in verdicts if v["agrees"]),
            )
    return findings, verdicts


def _print_verdict(v: dict) -> None:
    mark = "ok" if v["agrees"] and not v.get("findings") else "FAIL"
    problem = (f"kernel plan {v['name']}: shape={tuple(v['shape'])} rank={v['rank']} "
               f"itemsize={v['itemsize']} batch={v['batch']}")
    if v["plan"] is None:
        print(f"{problem} no plan [{mark}]")
        return
    print(f"{problem} {v['plan']} smem={v['smem_bytes']} launch={tuple(v['launch'])} [{mark}]")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.verify", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--only", default=None,
                    help=f"comma-separated analyzers to run (default: {','.join(PORTED)}; "
                    f"not ported yet: {','.join(a for a in ANALYZERS if a not in PORTED)})")
    ap.add_argument("--comm", action="store_true",
                    help="the communication verifier (not ported yet)")
    ap.add_argument("--dtypes", action="store_true",
                    help="the dtype-flow analyzer (not ported yet)")
    ap.add_argument("--rules", action="store_true",
                    help="the lint rule catalog (not ported yet)")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write verdicts as kind=static_verify JSONL span events "
                    "(repro_torch.observe schema)")
    args = ap.parse_args(argv)

    if args.rules:
        print(_not_ported(["lint"]), file=sys.stderr)
        return 2
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
    missing = [a for a in selected if a not in PORTED]
    if missing:
        print(_not_ported(missing), file=sys.stderr)
        return 2
    only = tuple(selected) if selected else PORTED

    findings, verdicts = run(only, trace_out=args.trace_out)
    for f in findings:
        print(f)
    for v in verdicts:
        _print_verdict(v)
    print(f"verify: {len(findings)} finding(s) across {', '.join(only)}; "
          f"{len(verdicts)} kernel plan(s); not run (not ported): "
          f"{', '.join(a for a in ANALYZERS if a not in PORTED)}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
