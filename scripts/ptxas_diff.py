#!/usr/bin/env python3
"""Registers and spills of every kernel instantiation in two build logs,
compared instantiation by instantiation.

    python3 scripts/ptxas_diff.py OLD.txt NEW.txt

Each log is ``chip_smoke.py``'s output (its ``nvcc <source>: ...`` lines,
the compiler's ``-Xptxas -v`` report of phase 2's build) or a raw ``nvcc
-Xptxas -v`` report. Prints one JSON line a differing instantiation (its
mangled name, the registers and spill bytes in each log) and a last line
with the counts; exits 1 if any instantiation differs or is in one log
only.
"""

from __future__ import annotations

import json
import re
import sys


def usage(path: str) -> dict[str, dict]:
    """``{mangled name: {"registers", "spill_stores", "spill_loads"}}`` of a log."""
    out: dict[str, dict] = {}
    name = None
    for line in open(path):
        line = line.split(": ", 1)[1] if line.startswith("nvcc ") else line
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = usage(argv[0]), usage(argv[1])
    differ = 0
    for name in sorted(set(old) | set(new)):
        if old.get(name) != new.get(name):
            differ += 1
            print(json.dumps({"kernel": name, "old": old.get(name), "new": new.get(name)}))
    print(json.dumps({"old": len(old), "new": len(new), "differ": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
