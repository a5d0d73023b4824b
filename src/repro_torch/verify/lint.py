"""Repo-specific AST lint over the port's own modules (``src/repro_torch``).
Counterpart of ``repro.verify.lint``.

Each rule encodes a bug class, not a style preference. Three carry over as
the reference words them:

* **RV101 falsy-or-default** — ``cache or default_cache()`` silently
  replaces an *empty* ``PlanCache``/``MetricsRegistry`` (they define
  ``__len__``, so emptiness is falsy) with a fresh default — the
  reference's PR-6 bug. Spell it ``x if x is not None else default()``.
* **RV104 mutable-default** — ``def f(x=[])`` / ``def f(x=make())``
  share one instance across calls.
* **RV105 wallclock** — ``time.*``/``datetime.now``/``random.*`` calls
  outside the measurement layers (``tune``, ``observe``, ``launch``,
  ``training``, ``checkpoint``, ``data``, as the reference scopes it) make
  the numeric layers nondeterministic. Two files time things on purpose:
  ``engine/execute.py`` (the dispatch spans' timing) and
  ``distributed/collectives.py`` (the host seconds each collective
  adds to ``COUNTER``).

Three are re-scoped to the port:

* **RV103 import-scope** — ``core/bounds.py``, ``engine/plan.py`` and
  ``distributed/grid_select.py`` are the equation layer and import
  neither ``torch`` nor ``jax``; and no module of the port imports
  ``jax`` or the reference package ``repro`` (the port's first rule: it
  runs where JAX is not installed).
* **RV107 raw-collective** — a ``torch.distributed`` collective or
  point-to-point call (``all_reduce``, ``all_gather*``,
  ``reduce_scatter*``, ``broadcast``, ``send``/``recv``,
  ``isend``/``irecv``, ``batch_isend_irecv``, ...) outside
  ``distributed/collectives.py`` escapes ``COUNTER``, so the sweeps'
  counted bytes (and :mod:`repro_torch.verify.comm`) would under-count.
  Set-up calls (``init_process_group``, ``new_group``, ``barrier``) are
  not collectives of the algorithms and are not flagged.
* **RV108 axis-literal** — a hard-coded mesh-axis string (``"r"`` or
  ``"m<k>"``) inside ``distributed/`` instead of ``mesh.RANK_AXIS`` /
  ``mesh.mode_axis(k)``; ``mesh.py``, where they are defined, is exempt.

The reference's RV102 (a Python branch on a traced value) and RV106 (the
removed ``pallas_dispatch_count`` shim) describe JAX's tracing and the
reference's history; the port traces nothing and never had the shim, so
they are not in its catalog (``docs/PORT.md``).

A finding on a line carrying ``# verify: allow=<code>`` (or
``allow=all``) is waived — the waiver is part of the diff, so exceptions
are reviewable.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Sequence

from . import Finding


@dataclass(frozen=True)
class Rule:
    """One lint rule: stable code, short name, what it catches and why."""

    code: str
    name: str
    summary: str


RULES: tuple[Rule, ...] = (
    Rule(
        "RV101", "falsy-or-default",
        "`x or default()` on a cache/registry object: emptiness is falsy "
        "(they define __len__), so an empty instance is silently replaced "
        "by a fresh default. Use `x if x is not None else default()`.",
    ),
    Rule(
        "RV103", "import-scope",
        "torch/jax import in the pure equation layer (core/bounds.py, "
        "engine/plan.py, distributed/grid_select.py), or a jax / repro "
        "(the reference) import anywhere in the port: the port runs where "
        "JAX is not installed.",
    ),
    Rule(
        "RV104", "mutable-default",
        "Mutable or call-valued default argument (list/dict/set literal "
        "or constructor call): one shared instance across all calls.",
    ),
    Rule(
        "RV105", "wallclock",
        "time/datetime/random call outside the measurement layers (tune/, "
        "observe/, launch/): the numeric/planning layers must be "
        "deterministic. engine/execute.py (span timing) and "
        "distributed/collectives.py (the collectives' host seconds) are "
        "the sanctioned exceptions.",
    ),
    Rule(
        "RV107", "raw-collective",
        "torch.distributed collective or point-to-point call outside "
        "distributed/collectives.py: it escapes COUNTER, so the sweeps' "
        "counted bytes (and repro_torch.verify.comm) under-count.",
    ),
    Rule(
        "RV108", "axis-literal",
        "Hard-coded mesh-axis string ('r' or 'm<k>') in distributed/ "
        "instead of mesh.RANK_AXIS / mesh.mode_axis(k): literals survive "
        "axis renames. mesh.py (the constants' home) is exempt.",
    ),
)

#: RV101: left operand names that look like stateful containers.
_CONTAINERISH = ("cache", "registry", "buf", "trace")

#: RV103 scope: the pure equation layer (paths relative to src/repro_torch).
PURE_MODULES = frozenset({
    "core/bounds.py", "engine/plan.py", "distributed/grid_select.py",
})
#: RV103: what no module of the port imports, and what the pure layer
#: does not import either.
_FOREIGN = ("jax", "repro")
_PURE_FOREIGN = ("jax", "torch")

#: RV105: sanctioned nondeterminism — the measurement layers, and the two
#: files that time things on purpose.
_WALLCLOCK_DIRS = ("tune", "observe", "launch", "training", "checkpoint", "data")
_WALLCLOCK_FILES = frozenset({
    "engine/execute.py",           # the dispatch spans' timing
    "distributed/collectives.py",  # the host seconds of each collective (COUNTER)
})
_WALLCLOCK_CALLS = frozenset({
    ("time", "time"), ("time", "perf_counter"), ("time", "monotonic"),
    ("time", "process_time"), ("time", "time_ns"),
    ("time", "perf_counter_ns"), ("datetime", "now"),
    ("datetime", "utcnow"), ("datetime", "today"),
    ("random", "random"), ("random", "randint"), ("random", "choice"),
    ("random", "shuffle"), ("random", "uniform"), ("random", "seed"),
})

#: RV107: torch.distributed's collectives and point-to-point calls, and the
#: one module allowed to spell them.
_COLLECTIVE_NAMES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "reduce_scatter", "reduce_scatter_tensor", "broadcast", "broadcast_object_list",
    "reduce", "gather", "scatter", "all_to_all", "all_to_all_single",
    "send", "recv", "isend", "irecv", "batch_isend_irecv",
})
_COLLECTIVE_HOME = "distributed/collectives.py"

#: RV108: axis-name literal shapes, and the module housing the constants.
_AXIS_LITERAL_RE = re.compile(r"^(r|m\d+)$")
_AXIS_HOME = "distributed/mesh.py"


def rule_catalog() -> str:
    """The rule catalog as a markdown table (printed by ``--rules``)."""
    lines = ["| code | name | what it catches |", "|------|------|-----|"]
    for r in RULES:
        lines.append(f"| {r.code} | {r.name} | {r.summary} |")
    return "\n".join(lines)


def _attr_chain(node: ast.AST) -> tuple[str, ...]:
    """`a.b.c` -> ("a", "b", "c"); empty when the root is not a Name."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _name_of(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def _in_dirs(relpath: str, dirs: Sequence[str]) -> bool:
    return relpath.split("/", 1)[0] in dirs


def _roots(node: ast.Import | ast.ImportFrom) -> list[str]:
    """The absolute modules an import names (a relative import names none)."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    return [node.module or ""] if node.level == 0 else []


def _is(module: str, top: str) -> bool:
    return module == top or module.startswith(top + ".")


def _dist_aliases(tree: ast.AST) -> set[tuple[str, ...]]:
    """The names ``torch.distributed`` goes by in a module (``dist`` for
    ``import torch.distributed as dist``, the full chain always)."""
    out = {("torch", "distributed")}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    out.add((a.asname,))
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module == "torch":
                for a in node.names:
                    if a.name == "distributed":
                        out.add((a.asname or a.name,))
    return out


def lint_source(src: str, relpath: str) -> list[Finding]:
    """Run every rule over one module's source. ``relpath`` is the path
    relative to ``src/repro_torch`` (posix separators) — several rules are
    scoped by layer."""
    try:
        tree = ast.parse(src, filename=relpath)
    except SyntaxError as e:
        return [Finding("lint", "syntax", relpath, f"unparsable: {e}")]
    lines = src.splitlines()
    findings: list[Finding] = []

    def waived(lineno: int, code: str) -> bool:
        if 1 <= lineno <= len(lines):
            text = lines[lineno - 1]
            if "verify: allow=" in text:
                allowed = text.split("verify: allow=", 1)[1].split()[0]
                return code in allowed.split(",") or allowed == "all"
        return False

    def emit(code: str, node: ast.AST, detail: str) -> None:
        lineno = getattr(node, "lineno", 0)
        if not waived(lineno, code):
            findings.append(Finding("lint", code, f"{relpath}:{lineno}", detail))

    pure = relpath in PURE_MODULES
    clock_ok = _in_dirs(relpath, _WALLCLOCK_DIRS) or relpath in _WALLCLOCK_FILES
    collectives_ok = relpath == _COLLECTIVE_HOME
    axis_scoped = _in_dirs(relpath, ("distributed",)) and relpath != _AXIS_HOME
    dist = _dist_aliases(tree) if not collectives_ok else set()

    for node in ast.walk(tree):
        # RV101 -------------------------------------------------------
        if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.Or):
            left = node.values[0]
            lname = _name_of(left).lower()
            if any(c in lname for c in _CONTAINERISH) and any(
                isinstance(v, ast.Call) for v in node.values[1:]
            ):
                emit(
                    "RV101", node,
                    f"`{_name_of(left)} or <call>` treats an EMPTY "
                    f"{_name_of(left)} as absent (it defines __len__); "
                    f"use `{_name_of(left)} if {_name_of(left)} is not "
                    f"None else <call>`",
                )
        # RV103 -------------------------------------------------------
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for m in _roots(node):
                if any(_is(m, top) for top in _FOREIGN):
                    emit("RV103", node,
                         f"`import {m}` in the port: repro_torch imports neither jax nor "
                         f"the reference package")
                elif pure and any(_is(m, top) for top in _PURE_FOREIGN):
                    emit("RV103", node,
                         f"`import {m}` in the pure equation layer; this module must stay "
                         f"array-free")
        # RV104 -------------------------------------------------------
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args
            for default in list(args.defaults) + [
                d for d in args.kw_defaults if d is not None
            ]:
                if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                    emit(
                        "RV104", default,
                        f"mutable default argument in `{node.name}`: one "
                        f"instance is shared across every call",
                    )
                elif isinstance(default, ast.Call):
                    emit(
                        "RV104", default,
                        f"call-valued default argument in `{node.name}`: "
                        f"evaluated once at def time, shared across calls",
                    )
        # RV105 -------------------------------------------------------
        if not clock_ok and isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            if len(chain) >= 2 and (chain[-2], chain[-1]) in _WALLCLOCK_CALLS:
                emit(
                    "RV105", node,
                    f"`{'.'.join(chain)}()` outside the measurement "
                    f"layers: this layer must be deterministic",
                )
        # RV107 -------------------------------------------------------
        if not collectives_ok:
            if isinstance(node, ast.Attribute) and node.attr in _COLLECTIVE_NAMES:
                chain = _attr_chain(node)
                if chain[:-1] in dist:
                    emit(
                        "RV107", node,
                        f"`{'.'.join(chain)}` outside distributed/collectives.py: "
                        f"it escapes COUNTER, so the sweeps' counted bytes under-count",
                    )
            if isinstance(node, ast.ImportFrom) and node.level == 0 and \
                    _is(node.module or "", "torch.distributed"):
                for a in node.names:
                    if a.name in _COLLECTIVE_NAMES:
                        emit(
                            "RV107", node,
                            f"importing collective `{a.name}` from {node.module} outside "
                            f"distributed/collectives.py",
                        )
        # RV108 -------------------------------------------------------
        if axis_scoped and isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and \
                _AXIS_LITERAL_RE.match(node.value):
            emit(
                "RV108", node,
                f"hard-coded mesh-axis literal '{node.value}': use "
                f"mesh.RANK_AXIS / mesh.mode_axis(k) so axis renames "
                f"stay one-line changes",
            )
    return findings


def iter_module_paths(root: Path) -> Iterable[tuple[Path, str]]:
    """Yield ``(path, relpath)`` for every Python module under the package
    root (``src/repro_torch``), relpath posix-style."""
    for path in sorted(root.rglob("*.py")):
        yield path, path.relative_to(root).as_posix()


def lint_tree(root: Path | None = None) -> list[Finding]:
    """Lint every module of the ``repro_torch`` package (or an explicit
    package root)."""
    if root is None:
        root = Path(__file__).resolve().parent.parent
    findings: list[Finding] = []
    for path, relpath in iter_module_paths(Path(root)):
        findings += lint_source(path.read_text(), relpath)
    return findings
